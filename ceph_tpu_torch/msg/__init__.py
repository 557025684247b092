"""ceph_tpu_torch.msg — wire layer (reference: src/msg/async — AsyncMessenger,
AsyncConnection, ProtocolV2; interface Messenger/Connection/Dispatcher in
src/msg/Messenger.h; SURVEY.md §5.8).

Re-design notes: the reference runs epoll event loops with N worker
threads; here each bound messenger has an accept thread and each connection
a reader thread (Python sockets, blocking I/O) — the *interfaces* mirror
the reference so the daemon code above reads the same: `Messenger.create`,
`Connection.send_message`, `Dispatcher.ms_dispatch` / `ms_handle_reset`.
Frames carry a crc32c like ProtocolV2; policies are lossy (clients: a reset
surfaces to the dispatcher, the Objecter resends) vs lossless-peer
(OSD↔OSD: transparent reconnect + replay of unacked frames).
"""
from .message import (
    Message,
    MPing,
    decode_message,
    encode_message,
    register_message,
)
from .messenger import Connection, Dispatcher, Messenger

__all__ = [
    "Connection",
    "Dispatcher",
    "MPing",
    "Message",
    "Messenger",
    "decode_message",
    "encode_message",
    "register_message",
]
