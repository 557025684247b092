"""OSD wire payload helpers — the part of ceph_tpu/osd/messages.py the
read batcher needs.

Bulk payloads (object data, chunk bytes) ride as base64 inside the JSON
body of the data-plane messages; the message classes come with the
messenger and monitor (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import base64


def pack_data(data: bytes | None) -> str | None:
    return None if data is None else base64.b64encode(bytes(data)).decode()


def unpack_data(s: str | None) -> bytes | None:
    return None if s is None else base64.b64decode(s)
