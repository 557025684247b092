"""The messenger and the wire messages of the port against the reference.

Every registered message type of msg, mon, mgr and osd encodes to the same
bytes in both packages and decodes across them; a port Messenger and a
reference Messenger exchange messages over loopback with crc, zlib wire
compression and cephx frame signing on, each way; and the reference's
messenger cases (tests/test_msg.py, less the cluster case, which waits
for the cluster slice) run against the port.  The lossless-replay case
asserts the reference test's own contract, ordered and exactly once.
"""
import threading
import time

import numpy as np
import pytest

import ceph_tpu.mgr.messages  # noqa: F401  (registers the mgr types)
import ceph_tpu.mon.messages  # noqa: F401
import ceph_tpu.osd.messages  # noqa: F401
import ceph_tpu_torch.mgr.messages  # noqa: F401
import ceph_tpu_torch.mon.messages  # noqa: F401
import ceph_tpu_torch.osd.messages  # noqa: F401
from ceph_tpu.common.context import CephContext as RefContext
from ceph_tpu.msg import Dispatcher as RefDispatcher
from ceph_tpu.msg import Messenger as RefMessenger
from ceph_tpu.msg import message as ref_message
from ceph_tpu_torch.common.context import CephContext
from ceph_tpu_torch.common.buffer import BufferList
from ceph_tpu_torch.msg import (
    Dispatcher,
    Message,
    Messenger,
    MPing,
    decode_message,
    encode_message,
    register_message,
)
from ceph_tpu_torch.msg import message as port_message
from ceph_tpu_torch.msg.messenger import POLICY_LOSSLESS_PEER
from ceph_tpu_torch.osd.messages import pack_data

# ---- every registered message type, byte for byte across packages ----

#: the modules whose message types this slice ports; other tests load
#: more of the reference (its fs messages) and add 9001, MTestData, to
#: each table
MODULES = ("msg.message", "mon.messages", "mgr.messages", "osd.messages")


def _table(registry, pkg):
    return {c: cls.__name__ for c, cls in registry.items()
            if cls.__module__ in {f"{pkg}.{m}" for m in MODULES}}


CODES = sorted(_table(port_message._REGISTRY, "ceph_tpu_torch"))


def _value(rng, depth=0):
    """A seeded JSON value: ints, strings, floats, bools, None, lists,
    dicts, and base64 data as the data-plane messages carry it."""
    kind = int(rng.integers(0, 8 if depth < 2 else 5))
    if kind == 0:
        return int(rng.integers(-(1 << 40), 1 << 40))
    if kind == 1:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, int(rng.integers(0, 24))))
    if kind == 2:
        return float(rng.normal())
    if kind == 3:
        return [None, True, False][int(rng.integers(0, 3))]
    if kind == 4:
        return pack_data(rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes())
    if kind in (5, 6):
        return [_value(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]
    return {f"k{i}": _value(rng, depth + 1) for i in range(int(rng.integers(0, 5)))}


def _sample(registry, code, seed):
    cls = registry[code]
    if code == MPing.MSG_TYPE:
        msg = cls(f"note {seed} \u00e9")
    else:
        rng = np.random.default_rng(seed)
        msg = cls(**{f: _value(rng) for f in cls.FIELDS})
    msg.seq, msg.src = seed * 7919, f"osd.{seed % 97}"
    return msg


def _fields(msg):
    names = getattr(msg, "FIELDS", ("note",))
    return (type(msg).__name__, msg.seq, msg.src, {f: getattr(msg, f) for f in names})


def test_both_packages_register_the_same_types():
    ref = _table(ref_message._REGISTRY, "ceph_tpu")
    assert _table(port_message._REGISTRY, "ceph_tpu_torch") == ref
    assert len(CODES) == 28


@pytest.mark.parametrize("code", CODES)
def test_message_bytes_equal_and_cross_decode(code):
    for seed in range(3):
        ref_msg = _sample(ref_message._REGISTRY, code, 1000 * code + seed)
        port_msg = _sample(port_message._REGISTRY, code, 1000 * code + seed)
        wire = ref_message.encode_message(ref_msg)
        assert encode_message(port_msg) == wire
        assert _fields(decode_message(wire)) == _fields(ref_msg)
        back = ref_message.decode_message(encode_message(port_msg))
        assert _fields(back) == _fields(port_msg)
        assert type(back) is ref_message._REGISTRY[code]


# ---- a port Messenger and a reference Messenger over loopback ----


def _secure(ctx, secret):
    ctx.conf.set("ms_compress", "zlib")
    ctx.conf.set("ms_compress_min_size", 1024)
    ctx.conf.set("auth_cluster_required", "cephx")
    ctx.conf.set("auth_shared_secret", secret)
    return ctx


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_port_and_reference_messengers_talk(server_pkg):
    """crc on every frame, zlib compression on the big ones and cephx
    proof plus frame signing, between the two packages, both ways;
    replies travel back on the same connection."""
    from ceph_tpu_torch.auth import generate_secret

    secret = generate_secret()
    pkgs = {
        "port": (CephContext, Messenger, Dispatcher, port_message._REGISTRY),
        "reference": (RefContext, RefMessenger, RefDispatcher, ref_message._REGISTRY),
    }
    client_pkg = "reference" if server_pkg == "port" else "port"
    SCtx, SMsgr, SDisp, sreg = pkgs[server_pkg]
    CCtx, CMsgr, CDisp, creg = pkgs[client_pkg]
    got, replies = [], []

    class Echo(SDisp):
        def ms_dispatch(self, conn, msg):
            got.append(msg)
            conn.send_message(sreg[43](tid=msg.tid, result=len(msg.data or "")))
            return True

    class Sink(CDisp):
        def ms_dispatch(self, conn, msg):
            replies.append(msg)
            return True

    sctx, cctx = _secure(SCtx("srv"), secret), _secure(CCtx("cli"), secret)
    server = SMsgr.create(sctx, "osd.0")
    server.add_dispatcher(Echo())
    addr = server.bind(("127.0.0.1", 0))
    server.start()
    client = CMsgr.create(cctx, "osd.1")
    client.add_dispatcher(Sink())
    rng = np.random.default_rng(7)
    blobs = [pack_data(bytes(rng.integers(0, 4, n, dtype=np.uint8))) for n in
             (10, 5000, 100_000, 3, 64 << 10)]
    try:
        conn = client.connect(addr)
        for i, blob in enumerate(blobs):
            conn.send_message(creg[42](tid=i, oid=f"obj{i}", data=blob))
        deadline = time.monotonic() + 10
        while len(replies) < len(blobs) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [m.data for m in got] == blobs
        assert [(m.tid, m.src) for m in got] == [(i, "osd.1") for i in range(len(blobs))]
        assert [(m.tid, m.result) for m in replies] == [(i, len(b)) for i, b in enumerate(blobs)]
        assert client.comp_frames_sent == 3  # the three frames over 1 KiB
        assert conn._frame_key is not None  # frames signed
    finally:
        client.shutdown()
        server.shutdown()


def test_cephx_rejects_a_peer_with_another_secret():
    from ceph_tpu_torch.auth import generate_secret

    server = RefMessenger.create(_secure(RefContext("srv"), generate_secret()), "osd.0")
    addr = server.bind(("127.0.0.1", 0))
    server.start()
    client = Messenger.create(_secure(CephContext("cli"), generate_secret()), "osd.1")
    try:
        with pytest.raises(ConnectionError):
            client.connect(addr)
    finally:
        client.shutdown()
        server.shutdown()


# ---- the reference's messenger cases, run against the port ----


@register_message
class MTestData(Message):
    MSG_TYPE = 9001

    def __init__(self, blob: bytes = b"", n: int = 0):
        super().__init__()
        self.blob = blob
        self.n = n

    def encode_payload(self, bl: BufferList) -> None:
        bl.append_u64(self.n)
        bl.append_str(self.blob)

    def decode_payload(self, it) -> None:
        self.n = it.get_u64()
        self.blob = it.get_str_bytes()


class Collector(Dispatcher):
    def __init__(self):
        self.msgs = []
        self.resets = []
        self.event = threading.Event()

    def ms_dispatch(self, conn, msg):
        self.msgs.append((conn, msg))
        self.event.set()
        return True

    def ms_handle_reset(self, conn):
        self.resets.append(conn)
        self.event.set()

    def wait_msgs(self, n, timeout=5.0):
        deadline = time.monotonic() + timeout
        while len(self.msgs) < n and time.monotonic() < deadline:
            time.sleep(0.005)
        return len(self.msgs) >= n


@pytest.fixture
def cct():
    c = CephContext("test")
    yield c
    c.shutdown()


def make_pair(cct, policy=None):
    server = Messenger.create(cct, "osd.0")
    server.bind(("127.0.0.1", 0))
    if policy:
        server.default_policy = policy
    disp = Collector()
    server.add_dispatcher(disp)
    server.start()
    client = Messenger.create(cct, "client.1")
    if policy:
        client.default_policy = policy
    return server, disp, client


class TestCodec:
    def test_roundtrip(self):
        m = MTestData(b"\x00\x01payload", 42)
        m.seq, m.src = 7, "osd.3"
        out = decode_message(encode_message(m))
        assert isinstance(out, MTestData)
        assert (out.n, out.blob, out.seq, out.src) == (42, b"\x00\x01payload", 7, "osd.3")

    def test_unknown_type(self):
        m = MPing("x")
        raw = bytearray(encode_message(m))
        raw[0] = 0xEE
        raw[1] = 0xEE
        with pytest.raises(ValueError):
            decode_message(bytes(raw))

    def test_duplicate_registration_rejected(self):
        with pytest.raises(ValueError):
            @register_message
            class Clash(Message):
                MSG_TYPE = 9001


class TestMessenger:
    def test_send_and_dispatch(self, cct):
        server, disp, client = make_pair(cct)
        try:
            conn = client.connect(server.myaddr)
            conn.send_message(MTestData(b"hello", 1))
            conn.send_message(MTestData(b"world", 2))
            assert disp.wait_msgs(2)
            (c1, m1), (c2, m2) = disp.msgs
            assert m1.blob == b"hello" and m2.blob == b"world"
            assert m1.seq == 1 and m2.seq == 2  # in order
            assert m1.src == "client.1" and c1.peer_name == "client.1"
        finally:
            client.shutdown()
            server.shutdown()

    def test_bidirectional(self, cct):
        server, disp, client = make_pair(cct)

        class Echo(Dispatcher):
            def ms_dispatch(self, conn, msg):
                conn.send_message(MTestData(msg.blob.upper(), msg.n))
                return True

        server.dispatchers[0] = Echo()
        cdisp = Collector()
        client.add_dispatcher(cdisp)
        try:
            conn = client.connect(server.myaddr)
            conn.send_message(MTestData(b"abc", 5))
            assert cdisp.wait_msgs(1)
            assert cdisp.msgs[0][1].blob == b"ABC"
        finally:
            client.shutdown()
            server.shutdown()

    def test_large_frame(self, cct):
        server, disp, client = make_pair(cct)
        try:
            blob = bytes(range(256)) * (4 << 10)  # 1 MiB
            client.connect(server.myaddr).send_message(MTestData(blob, 0))
            assert disp.wait_msgs(1)
            assert disp.msgs[0][1].blob == blob
        finally:
            client.shutdown()
            server.shutdown()

    def test_client_sees_reset_on_server_shutdown(self, cct):
        server, disp, client = make_pair(cct)
        cdisp = Collector()
        client.add_dispatcher(cdisp)
        conn = client.connect(server.myaddr)
        conn.send_message(MPing())
        assert disp.wait_msgs(1)
        server.shutdown()
        deadline = time.monotonic() + 5
        while not cdisp.resets and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cdisp.resets == [conn]
        with pytest.raises(ConnectionError):
            conn.send_message(MPing())
        client.shutdown()

    def test_connection_reuse(self, cct):
        server, disp, client = make_pair(cct)
        try:
            c1 = client.connect(server.myaddr)
            c2 = client.connect(server.myaddr)
            assert c1 is c2
        finally:
            client.shutdown()
            server.shutdown()

    def test_lossless_replay_on_injected_failures(self, cct):
        # every 5th frame the socket is torn down mid-stream; the lossless
        # policy must reconnect + replay with no loss and no duplication
        server, disp, client = make_pair(cct, policy=POLICY_LOSSLESS_PEER)
        cct.conf.set("ms_inject_socket_failures", 5)
        try:
            conn = client.connect(server.myaddr)
            total = 37
            for i in range(total):
                conn.send_message(MTestData(b"m%d" % i, i))
            assert disp.wait_msgs(total), f"got {len(disp.msgs)}/{total}"
            ns = [m.n for _, m in disp.msgs]
            assert ns == list(range(total))  # ordered, exactly-once
        finally:
            cct.conf.set("ms_inject_socket_failures", 0)
            client.shutdown()
            server.shutdown()

    def test_lossy_conn_new_session_not_deduped(self, cct):
        # a brand-new lossy connection restarts seqs at 1; the server must
        # not confuse it with the previous session from the same entity
        server, disp, client = make_pair(cct)
        conn = client.connect(server.myaddr)
        conn.send_message(MTestData(b"first", 1))
        assert disp.wait_msgs(1)
        conn.mark_down()
        client2 = Messenger.create(cct, "client.1")
        conn2 = client2.connect(server.myaddr)
        conn2.send_message(MTestData(b"second", 2))
        assert disp.wait_msgs(2)
        assert disp.msgs[1][1].blob == b"second"
        client.shutdown()
        client2.shutdown()
        server.shutdown()

    def test_get_connection_by_name(self, cct):
        server, disp, client = make_pair(cct)
        try:
            conn = client.connect(server.myaddr)
            conn.send_message(MPing("hi"))
            assert disp.wait_msgs(1)
            sconn = server.get_connection("client.1")
            assert sconn is not None
            cdisp = Collector()
            client.add_dispatcher(cdisp)
            sconn.send_message(MPing("back"))
            assert cdisp.wait_msgs(1)
            assert cdisp.msgs[0][1].note == "back"
        finally:
            client.shutdown()
            server.shutdown()


class TestWireCompression:
    """On-wire frame compression (reference: ProtocolV2 compression
    frames gated by the sender's ms_osd_compress_* conf)."""

    def _pair(self, send_comp: str, recv_comp: str = "none"):
        from ceph_tpu_torch.common.context import CephContext
        from ceph_tpu_torch.msg import Dispatcher, Messenger

        got = []

        class Sink(Dispatcher):
            def ms_dispatch(self, conn, msg):
                got.append(msg)
                return True

        rc = CephContext("recv")
        rc.conf.set("ms_compress", recv_comp)
        rx = Messenger.create(rc, "rx")
        rx.add_dispatcher(Sink())
        addr = rx.bind(("127.0.0.1", 0))
        rx.start()
        sc = CephContext("send")
        sc.conf.set("ms_compress", send_comp)
        tx = Messenger.create(sc, "tx")
        tx.start()
        return tx, rx, addr, got

    def test_large_frames_compress_and_roundtrip(self):
        import time

        from ceph_tpu_torch.mon.messages import MMonCommand

        tx, rx, addr, got = self._pair("zlib")
        try:
            conn = tx.connect(addr)
            big = "A" * 200_000  # wildly compressible payload
            conn.send_message(MMonCommand(tid=1, cmd={"blob": big}))
            deadline = time.monotonic() + 10
            while not got and time.monotonic() < deadline:
                time.sleep(0.05)
            assert got and got[0].cmd["blob"] == big
            assert tx.comp_frames_sent == 1, "big frame stayed raw"
            # tiny frames stay raw (below ms_compress_min_size)
            conn.send_message(MMonCommand(tid=2, cmd={"blob": "tiny"}))
            deadline = time.monotonic() + 10
            while len(got) < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert len(got) == 2 and tx.comp_frames_sent == 1
        finally:
            tx.shutdown()
            rx.shutdown()

    def test_receiver_needs_no_conf(self):
        """Decompression is frame-driven: a receiver with compression
        off still reads compressed frames (sender-side knob only)."""
        import time

        from ceph_tpu_torch.mon.messages import MMonCommand

        tx, rx, addr, got = self._pair("zlib", recv_comp="none")
        try:
            conn = tx.connect(addr)
            conn.send_message(MMonCommand(tid=1, cmd={"blob": "B" * 50000}))
            deadline = time.monotonic() + 10
            while not got and time.monotonic() < deadline:
                time.sleep(0.05)
            assert got and got[0].cmd["blob"] == "B" * 50000
        finally:
            tx.shutdown()
            rx.shutdown()

    def test_incompressible_frames_stay_raw(self):
        import os
        import time

        from ceph_tpu_torch.mon.messages import MMonCommand
        from ceph_tpu_torch.osd.messages import pack_data

        tx, rx, addr, got = self._pair("zlib")
        try:
            conn = tx.connect(addr)
            noise = pack_data(os.urandom(100_000))  # b64 of random bytes
            conn.send_message(MMonCommand(tid=1, cmd={"blob": noise}))
            deadline = time.monotonic() + 10
            while not got and time.monotonic() < deadline:
                time.sleep(0.05)
            assert got and got[0].cmd["blob"] == noise
            # b64 noise barely compresses; zlib may still shave a few
            # percent, so just assert integrity here — the raw-stays-raw
            # contract is covered by the tiny-frame case above
        finally:
            tx.shutdown()
            rx.shutdown()


def test_decompression_bomb_rejected():
    """A frame whose declared inflated size exceeds ms_max_frame_len —
    or whose stream inflates past its declaration — must be rejected
    before the allocation, killing the connection, not the process."""
    import struct
    import time
    import zlib

    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.common.crc32c import crc32c
    from ceph_tpu_torch.msg import Dispatcher, Messenger

    got = []

    class Sink(Dispatcher):
        def ms_dispatch(self, conn, msg):
            got.append(msg)
            return True

    rc = CephContext("recv")
    rc.conf.set("ms_max_frame_len", 1 << 20)
    rx = Messenger.create(rc, "rx")
    rx.add_dispatcher(Sink())
    addr = rx.bind(("127.0.0.1", 0))
    rx.start()
    try:
        import socket as s

        # hand-craft a compressed frame declaring 512 MiB inflated
        z = zlib.compress(b"\x00" * 1024)
        body = (bytes([2, 4]) + b"zlib"
                + struct.pack("<I", 512 << 20) + z)
        frame = struct.pack("<II", len(body), crc32c(body)) + body
        sk = s.create_connection(addr, timeout=5)
        sk.sendall(frame)
        # connection must die (receiver refuses), nothing dispatched
        sk.settimeout(5)
        try:
            assert sk.recv(1) == b""  # FIN
        except ConnectionResetError:
            pass  # RST: equally dead
        sk.close()
        assert not got
        # and a LYING header (small declaration, bigger stream) dies too
        z2 = zlib.compress(b"\x00" * 100_000)
        body2 = (bytes([2, 4]) + b"zlib"
                 + struct.pack("<I", 10) + z2)
        frame2 = struct.pack("<II", len(body2), crc32c(body2)) + body2
        sk2 = s.create_connection(addr, timeout=5)
        sk2.sendall(frame2)
        sk2.settimeout(5)
        try:
            assert sk2.recv(1) == b""
        except ConnectionResetError:
            pass
        sk2.close()
        assert not got
    finally:
        rx.shutdown()


def test_non_zlib_wire_compression_needs_force():
    import pytest as _pytest

    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.msg import Messenger

    cct = CephContext("t")
    cct.conf.set("ms_compress", "zstd")
    with _pytest.raises(ValueError, match="ms_compress_force"):
        Messenger.create(cct, "tx")
