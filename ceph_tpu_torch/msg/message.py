"""Message base class + type registry (reference: src/msg/Message.h ::
Message with ceph_msg_header/footer; concrete types in src/messages/*.h).

A Message is a typed struct that knows how to encode/decode its payload
through BufferList.  Subclasses register a numeric type code — subsystem
modules (osd, mon) register their own types exactly as src/messages/ does
via the decode_message switch.  Type codes follow the reference's
CEPH_MSG_*/MSG_* numbering where one exists.
"""
from __future__ import annotations

from ..common.buffer import BufferList, BufferListIterator

_REGISTRY: dict[int, type["Message"]] = {}


def register_message(cls: type["Message"]) -> type["Message"]:
    """Class decorator: add to the decode switch (reference:
    decode_message() in src/msg/Message.cc)."""
    code = cls.MSG_TYPE
    if code in _REGISTRY and _REGISTRY[code] is not cls:
        raise ValueError(
            f"message type {code} already registered to {_REGISTRY[code].__name__}"
        )
    _REGISTRY[code] = cls
    return cls


class Message:
    MSG_TYPE = 0

    def __init__(self):
        self.seq = 0  # per-connection sequence, stamped at send
        self.src = ""  # sender entity name, stamped at send

    # subclasses override these two
    def encode_payload(self, bl: BufferList) -> None:
        pass

    def decode_payload(self, it: BufferListIterator) -> None:
        pass

    def get_type(self) -> int:
        return self.MSG_TYPE

    def __repr__(self):
        return f"<{type(self).__name__} seq={self.seq} src={self.src!r}>"


def encode_message(msg: Message) -> bytes:
    bl = BufferList()
    bl.append_u16(msg.MSG_TYPE)
    bl.append_u64(msg.seq)
    bl.append_str(msg.src)
    msg.encode_payload(bl)
    return bytes(bl)


def decode_message(payload: bytes) -> Message:
    it = BufferListIterator(payload)
    code = it.get_u16()
    cls = _REGISTRY.get(code)
    if cls is None:
        raise ValueError(f"unknown message type {code}")
    msg = cls.__new__(cls)
    Message.__init__(msg)
    msg.seq = it.get_u64()
    msg.src = it.get_str()
    msg.decode_payload(it)
    return msg


@register_message
class MPing(Message):
    """reference: src/messages/MPing.h — liveness probe."""

    MSG_TYPE = 2  # CEPH_MSG_PING

    def __init__(self, note: str = ""):
        super().__init__()
        self.note = note

    def encode_payload(self, bl: BufferList) -> None:
        bl.append_str(self.note)

    def decode_payload(self, it: BufferListIterator) -> None:
        self.note = it.get_str()
