"""Threaded TCP messenger (reference: src/msg/async/AsyncMessenger.cc,
AsyncConnection.cc, ProtocolV2.cc; SURVEY.md §5.8).

Wire format, after a banner/identify exchange:
    frame := [u32 len][u32 crc32c(body, seed -1)][body]
    body  := [u8 ftype][payload]
    ftype 0 (message): payload = encode_message() bytes
    ftype 1 (ack):     payload = u64 seq — receiver has consumed through seq
                       (reference: ProtocolV2 ACK frames)
A bad crc, an oversized frame, an undecodable message, or a dispatcher
exception kills the connection, like ProtocolV2.  Acks keep the lossless
replay queue to unacked messages only, so session replay after a reconnect
is short and idempotent.

Policies (reference: Messenger::Policy):
- lossy (client side): a dead connection is reported via ms_handle_reset
  and the caller (Objecter/MonClient) resends at its layer.
- lossless_peer (OSD↔OSD): sends transparently reconnect and replay
  unacked frames; the receiver drops seq <= in_seq duplicates (ProtocolV2
  session replay), giving in-order exactly-once delivery per session.
The connector advertises its policy in the banner and the acceptor adopts
it, so both halves of a session always agree.

Locking: ONE reentrant lock per session (`_Session.lock`) serializes all
of a connection's send state, receive ordering, reconnect, and dispatch.
A dispatcher may therefore send on the connection it was called from
(reentrant), and a stale reader of a replaced socket cannot interleave
with the replacement (it re-checks socket identity under the lock).  The
coarse-grained lock trades throughput for obviousness; the reference gets
the same effect with its per-connection event-loop thread affinity.

Fault injection (common/failpoint.py; docs/fault_injection.md): message
frames pass the `msgr.frame.send` failpoint before hitting the wire (an
error action tears the socket down mid-stream — `ms_inject_socket_failures
= N` is the legacy spelling, routed through the registry as
every(N,error)) and the `msgr.frame.recv` failpoint after decode (an error
action silently swallows the frame, the thrasher's netsplit primitive —
the frame is neither dispatched nor acked, exactly a lossy network).

Auth (reference: ProtocolV2 auth frames + signed frames; SURVEY.md §2.7):
with `auth_cluster_required = cephx` the handshake runs the cephx exchange
(auth/cephx.py wire form) in one of two modes — shared-secret
proof (daemons, admin clients) or mon-minted service ticket (limited
clients, validated against the OSDMap's current auth generation) — and
every post-handshake frame then carries a 16-byte HMAC tag over
(per-direction counter || body) under the negotiated per-connection
session key.  A missing or bad tag is connection-fatal, so a
post-handshake frame can be neither forged, tampered with, nor replayed
within a session.
"""
from __future__ import annotations

import hmac as _hmac
import random
import socket
import struct
import threading
import time
from collections import deque

from ..auth.cephx import (
    frame_tag,
    proof_hex,
    session_key_from_nonces,
    validate_ticket,
)
from ..common.crc32c import crc32c
from ..common.lockdep import make_lock
from ..common.tracer import TRACER
from ..common.failpoint import (
    FailpointCrash,
    FailpointError,
    failpoint,
    registry as _registry,
)
from .message import Message, decode_message, encode_message

_TAG_LEN = 16
# handshake lines are bounded; the auth-ticket reply carries a sealed
# ~450-byte hex blob plus proof + nonce, so the auth exchange gets a
# larger budget than the short banner/ident lines
_AUTH_LINE_LIMIT = 4096

_BANNER = b"ceph_tpu msgr v1\n"


def _os_nonce() -> str:
    import os

    return os.urandom(16).hex()

_FRAME_MSG = 0
_FRAME_ACK = 1
# compressed message frame (reference: ProtocolV2 compression frames):
# body = [2][u8 algo_len][algo name][compressed payload].  The RECEIVE
# side is configuration-independent — it decompresses by the named
# algorithm from the registry — so only the sender's ms_compress knob
# governs whether a link compresses (the reference's ms_osd_compress_*
# conf gates the sender the same way)
_FRAME_MSG_Z = 2
# delivery attempts for a message whose dispatcher keeps raising before it
# is dropped-and-acked as poison (at-least-once, bounded)
_POISON_RETRIES = 3

POLICY_LOSSY = "lossy"
POLICY_LOSSLESS_PEER = "lossless_peer"


class _Session:
    """Per-session state shared across socket reincarnations of one peer
    session (reference: ProtocolV2 session state kept over reconnects)."""

    __slots__ = ("in_seq", "lock", "dispatch_lock", "fail_seq", "fail_count")

    def __init__(self):
        self.in_seq = 0
        self.lock = make_lock("msgr::session")
        # held by a reader from its dedup check through the dispatch to the
        # in_seq advance: two socket incarnations of one session (the dead
        # socket's reader draining its buffer, the new one reading the
        # replay) then deliver each seq once, in order
        self.dispatch_lock = make_lock("msgr::session_dispatch")
        # poison-message tracking: seq of the last message whose dispatch
        # raised, and how many delivery attempts it has burned
        self.fail_seq = -1
        self.fail_count = 0


class Dispatcher:
    """Upcall interface (reference: src/msg/Dispatcher.h)."""

    def ms_dispatch(self, conn: "Connection", msg: Message) -> bool:
        return False

    def ms_handle_reset(self, conn: "Connection") -> None:
        pass


class Connection:
    """One peer session (reference: AsyncConnection + ProtocolV2 state)."""

    def __init__(self, msgr: "Messenger", sock: socket.socket | None,
                 peer_addr, policy: str, outgoing: bool,
                 session: "_Session | None" = None):
        self.msgr = msgr
        self.sock = sock
        self.peer_addr = peer_addr
        self.peer_name = ""
        self.policy = policy
        self.outgoing = outgoing
        self.out_seq = 0
        # connect incarnation: advertised in the banner so the acceptor can
        # tie socket reincarnations of a lossless session together and keep
        # deduping replayed seqs (reference: ProtocolV2 client_cookie)
        self.connect_id = random.getrandbits(63)
        self._session = session if session is not None else _Session()
        # unacked frames for lossless replay; unbounded — backpressure is
        # the job of higher-layer throttles (objecter_inflight_ops), and a
        # bounded deque here would silently break the no-loss contract
        self._replay: deque[tuple[int, bytes]] = deque()
        self._closed = False
        # per-connection frame-signing key + send counter, reset together
        # with every socket incarnation (fresh handshake = fresh key); the
        # receive counter lives in the reader thread, which is also
        # per-incarnation
        self._frame_key: bytes | None = None
        self._tx_ctr = 0

    @property
    def _lock(self) -> threading.RLock:
        return self._session.lock

    @property
    def in_seq(self) -> int:
        return self._session.in_seq

    @in_seq.setter
    def in_seq(self, v: int) -> None:
        self._session.in_seq = v

    # -- sending ----------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        with self._lock:
            if self._closed:
                raise ConnectionError(f"connection to {self.peer_addr} is down")
            self.out_seq += 1
            msg.seq = self.out_seq
            msg.src = self.msgr.name
            if TRACER.enabled:  # one attribute check when tracing is off
                t_id = getattr(msg, "trace_id", None)
                if t_id is not None:
                    TRACER.tracepoint(
                        "msgr", "send", entity=self.msgr.name,
                        trace_id=t_id, msg=type(msg).__name__,
                        peer=self.peer_name or str(self.peer_addr),
                    )
            payload = encode_message(msg)
            if self.policy == POLICY_LOSSLESS_PEER:
                self._replay.append((self.out_seq, payload))
            try:
                self._send_frame(_FRAME_MSG, payload)
            except OSError:
                if self.policy == POLICY_LOSSLESS_PEER and self.outgoing:
                    self._reconnect_and_replay()
                else:
                    self.mark_down()
                    raise ConnectionError(
                        f"connection to {self.peer_addr} reset"
                    ) from None

    def _send_frame(self, ftype: int, payload: bytes, inject: bool = True) -> None:
        if (inject and ftype == _FRAME_MSG
                and _registry().configured("msgr.frame.send")):
            try:
                failpoint(
                    "msgr.frame.send", cct=self.msgr.cct,
                    entity=self.msgr.name, peer=self.peer_name or None,
                )
            except FailpointCrash:
                raise
            except FailpointError:
                # simulate a peer reset mid-stream (the legacy
                # ms_inject_socket_failures behavior)
                if self.sock is not None:
                    try:
                        self.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                raise OSError("injected socket failure") from None
        if self.sock is None:
            raise OSError("not connected")
        comp = self.msgr._wire_comp
        if (
            ftype == _FRAME_MSG and comp is not None
            and len(payload) >= self.msgr._wire_min_size
        ):
            z = comp.compress(payload)
            name = self.msgr._wire_comp_name.encode()
            if len(z) + len(name) + 6 < len(payload):
                ftype = _FRAME_MSG_Z
                # declared raw length up front: the receiver bounds its
                # allocation BEFORE inflating (decompression-bomb guard)
                payload = (bytes([len(name)]) + name
                           + struct.pack("<I", len(payload)) + z)
                # messenger-wide counter shared by every connection's send
                # path: the increment must not lose updates under
                # concurrent sends (sessions hold only their own lock)
                with self.msgr._lock:
                    self.msgr.comp_frames_sent += 1
        body = bytes([ftype]) + payload
        frame = struct.pack("<II", len(body), crc32c(body)) + body
        if self._frame_key is not None:
            frame += frame_tag(self._frame_key, self._tx_ctr, body)
            self._tx_ctr += 1
        self.sock.sendall(frame)

    def _send_ack(self, seq: int) -> None:
        with self._lock:
            try:
                self._send_frame(_FRAME_ACK, struct.pack("<Q", seq))
            except OSError:
                pass  # the reconnect path re-acks via dedup

    def _handle_ack(self, seq: int) -> None:
        with self._lock:
            while self._replay and self._replay[0][0] <= seq:
                self._replay.popleft()

    def _reconnect_and_replay(self) -> None:
        """Lossless-peer session replay (reference: ProtocolV2 reconnect).
        Runs under the session lock, so socket swap + in_seq reset are
        atomic with respect to any stale reader's dispatch re-check."""
        last_err: OSError | None = None
        for _ in range(3):
            try:
                sock, fkey = self.msgr._open_socket(
                    self.peer_addr, self.connect_id, self.policy
                )
                self.sock = sock
                self._frame_key, self._tx_ctr = fkey, 0
                # the peer's responding half restarts at seq 1 on a fresh
                # socket (its duplicate requests are dropped, so replies
                # are never duplicated) — restart our receive expectation
                self.in_seq = 0
                self.msgr._start_reader(self)
                for _seq, payload in list(self._replay):
                    self._send_frame(_FRAME_MSG, payload, inject=False)
                return
            except OSError as e:
                last_err = e
                time.sleep(0.05)
        self.mark_down()
        raise ConnectionError(
            f"lossless reconnect to {self.peer_addr} failed: {last_err}"
        ) from None

    def mark_down(self) -> None:
        """Tear down without notifying the dispatcher (reference:
        Connection::mark_down)."""
        self._closed = True
        if self.sock is not None:
            # shutdown() (not just close()) so a reader blocked in recv on
            # this socket wakes immediately and the peer sees FIN
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
        self.msgr._forget(self)

    @property
    def is_connected(self) -> bool:
        return not self._closed and self.sock is not None


class Messenger:
    """reference: Messenger::create + AsyncMessenger."""

    def __init__(self, cct, name: str):
        self.cct = cct
        self.name = name  # entity name, e.g. "osd.3"
        self.myaddr: tuple[str, int] | None = None
        self.dispatchers: list[Dispatcher] = []
        self.default_policy = POLICY_LOSSY
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conns: dict[tuple[str, int], Connection] = {}
        self._conns_by_name: dict[str, Connection] = {}
        # (peer_name, connect_id) -> _Session surviving reconnects
        self._sessions: dict[tuple[str, int], _Session] = {}
        self._lock = make_lock("msgr::messenger")
        # stop flag as an Event: a plain bool here is a write/read race
        # between shutdown() and the accept/rx loops (cephrace CR1); the
        # Event is the same idiom Monitor uses for its stop flag
        self._stop_event = threading.Event()
        # cephx-style mutual auth (reference: ProtocolV2 auth frames);
        # engine built lazily from config so tests can flip it per-context
        self._auth = None
        self._auth_checked = False
        # on-wire compression (sender-side knob; see _FRAME_MSG_Z).
        # Default policy restricts the WIRE to zlib — the one algorithm
        # every receiver can construct (stdlib) — because there is no
        # capability negotiation in the handshake: a receiver missing an
        # optional module would fail the frame connection-fatally and
        # the lossless replay would loop.  ms_compress_force overrides
        # for fleets known to carry the module everywhere.
        self._wire_comp = None
        self._wire_comp_name = ""
        self._wire_min_size = 4096
        algo = cct.conf.get("ms_compress") if cct else "none"
        if algo and algo != "none":
            if algo != "zlib" and not (
                cct and cct.conf.get("ms_compress_force")
            ):
                raise ValueError(
                    f"ms_compress={algo!r} needs ms_compress_force=true "
                    f"(no wire negotiation: every peer must carry the "
                    f"module; zlib is the negotiation-free default)"
                )
            from ..compressor import Compressor

            self._wire_comp = Compressor.create(algo)
            self._wire_comp_name = algo
            self._wire_min_size = cct.conf.get("ms_compress_min_size")
        self._wire_decomp: dict[str, object] = {}
        #: frames actually sent compressed (observability/tests)
        self.comp_frames_sent = 0

    def _auth_required(self) -> bool:
        return (
            self.cct is not None
            and self.cct.conf.get("auth_cluster_required") == "cephx"
        )

    def _authenticator(self):
        """Shared-secret engine, or None when no secret is configured —
        which on a cephx-required CONNECTOR means ticket mode (the
        credentials live in cct.tickets), and on a cephx-required ACCEPTOR
        means misconfiguration (every peer is rejected: only secret
        holders can validate anything — fail closed)."""
        # fully under the messenger lock: concurrent handshake threads
        # racing the lazy init was a write/read race on _auth_checked
        # (cephrace CR1); handshakes are rare enough that a fast path
        # is not worth the unsynchronized read
        with self._lock:
            if not self._auth_checked:
                if self._auth_required() \
                        and self.cct.conf.get("auth_shared_secret"):
                    from ..auth import CephxAuthenticator

                    # construct BEFORE marking checked: a bad secret must
                    # stay a loud failure on every connection (fail
                    # closed), never silently disable auth on a
                    # cephx-required messenger
                    self._auth = CephxAuthenticator(
                        self.cct.conf.get("auth_shared_secret")
                    )
                self._auth_checked = True
            return self._auth

    @property
    def auth_service(self) -> str:
        """Service this messenger serves as, announced in the challenge so
        ticket clients pick the right ticket: the entity-name type prefix
        ('osd.3' -> 'osd', the reference's entity_name_t type)."""
        return self.name.split(".", 1)[0]

    # Current auth generation for ticket validation; daemons point this at
    # their OSDMap view (osdmap.auth_gens) so `auth rotate` propagates
    # through the normal map-subscription path (the CephxKeyServer
    # rotating_secrets role).  None -> generation 1 (rotation never used).
    auth_gen_provider = None

    @staticmethod
    def _read_line(sock: socket.socket, limit: int = 512) -> str:
        line = b""
        while not line.endswith(b"\n"):
            if len(line) > limit:
                raise ConnectionError("auth line too long")
            b = sock.recv(1)
            if not b:
                raise ConnectionError("peer closed during auth")
            line += b
        return line.decode().strip()

    @classmethod
    def create(cls, cct, name: str) -> "Messenger":
        return cls(cct, name)

    def _dout(self, level: int, msg: str) -> None:
        if self.cct is not None:
            self.cct.dout("ms", level, f"{self.name}: {msg}")

    # -- setup ------------------------------------------------------------
    def add_dispatcher(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    def bind(self, addr: tuple[str, int] = ("127.0.0.1", 0)) -> tuple[str, int]:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(addr)
        s.listen(64)
        self._listener = s
        self.myaddr = s.getsockname()
        return self.myaddr

    def start(self) -> None:
        if self._listener is not None and self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"msgr-{self.name}", daemon=True
            )
            self._accept_thread.start()

    @property
    def _stopped(self) -> bool:
        return self._stop_event.is_set()

    def shutdown(self) -> None:
        self._stop_event.set()
        # take the listener under the lock (two shutdown() racers would
        # double-close), tear it down after release
        with self._lock:
            listener, self._listener = self._listener, None
            conns = list(self._conns.values())
        if listener is not None:
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                listener.close()
            except OSError:
                pass
        for c in conns:
            c.mark_down()
        # the accept loop wakes on the closed listener; reap it so a
        # stopped messenger leaves no thread behind (join is idempotent
        # under racing shutdowns; current_thread guards a self-stop)
        if (self._accept_thread is not None
                and self._accept_thread is not threading.current_thread()):
            self._accept_thread.join(timeout=5)
        self._accept_thread = None

    # -- outgoing ---------------------------------------------------------
    def connect(
        self, addr: tuple[str, int], policy: str | None = None
    ) -> Connection:
        """Get-or-create a connection (reference:
        Messenger::connect_to/get_connection).  The blocking dial happens
        outside the messenger lock; a lost creation race closes the extra
        socket and returns the winner."""
        addr = (addr[0], addr[1])
        if self._stopped:
            raise ConnectionError(f"messenger {self.name} is shut down")
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and conn.is_connected:
                return conn
        fresh = Connection(
            self, None, addr, policy or self.default_policy, outgoing=True
        )
        sock, fkey = self._open_socket(addr, fresh.connect_id, fresh.policy)
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and conn.is_connected:
                try:
                    sock.close()
                except OSError:
                    pass
                return conn
            fresh.sock = sock
            fresh._frame_key = fkey
            self._conns[addr] = fresh
        self._start_reader(fresh)
        return fresh

    def _open_socket(
        self, addr: tuple[str, int], connect_id: int, policy: str
    ) -> tuple[socket.socket, bytes | None]:
        """Dial + banner + (when cephx-required) the auth handshake.
        Returns (socket, frame-signing key or None)."""
        timeout = self.cct.conf.get("ms_connect_timeout") if self.cct else 10.0
        sock = socket.create_connection(addr, timeout=timeout)
        sock.settimeout(None)
        if self.cct is None or self.cct.conf.get("ms_tcp_nodelay"):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # banner + identify (reference: ProtocolV2 banner/hello frames; the
        # connect_id plays client_cookie's role, and the policy rides along
        # so the acceptor's half agrees with ours)
        sock.sendall(_BANNER + f"{self.name} {connect_id} {policy}\n".encode())
        try:
            auth = self._authenticator()
        except Exception as e:
            sock.close()
            raise ConnectionError(f"auth misconfigured: {e}") from e
        if not self._auth_required():
            return sock, None
        # mutual cephx-style exchange (auth/cephx.py wire form):
        # shared-secret proof when we hold the keyring, service ticket
        # otherwise.  A server WITHOUT auth sends no challenge -> we time
        # out, the same hard failure a cephx-required cluster hands a peer
        try:
            sock.settimeout(timeout)
            kind, snonce, service = self._read_line(
                sock, _AUTH_LINE_LIMIT
            ).split()
            if kind != "auth-challenge":
                raise ConnectionError(f"expected challenge, got {kind}")
            cnonce = _os_nonce()
            if auth is not None:
                sock.sendall(
                    f"auth-proof {auth.proof(snonce, self.name)} {cnonce}\n"
                    .encode()
                )
                fkey = auth.session_key(snonce, cnonce)
            else:
                t = (getattr(self.cct, "tickets", None) or {}).get(service)
                if t is None:
                    raise ConnectionError(
                        f"server requires cephx and no secret or "
                        f"{service!r} ticket is available"
                    )
                skey = bytes.fromhex(t["session_key"])
                sock.sendall(
                    f"auth-ticket {t['ticket']} "
                    f"{proof_hex(skey, snonce, self.name)} {cnonce}\n"
                    .encode()
                )
                # frame key mixes BOTH nonces so every socket incarnation
                # signs under a fresh key — reusing the raw ticket session
                # key would let frames recorded on one incarnation replay
                # on the next at the same counter positions
                fkey = session_key_from_nonces(skey, snonce, cnonce)
            kind, sproof = self._read_line(sock, _AUTH_LINE_LIMIT).split()
            # the server proves as 'cluster': any cluster-secret holder is
            # equally trusted, so the entity name adds nothing (proof
            # mode); in ticket mode it proves possession of the ticket's
            # session key, which only a service-key holder could unseal
            if kind != "auth-ok" or not _hmac.compare_digest(
                proof_hex(skey, cnonce, "cluster")
                if auth is None
                else auth.proof(cnonce, "cluster"),
                sproof,
            ):
                raise ConnectionError("server failed mutual auth")
            sock.settimeout(None)
        except (OSError, ValueError) as e:
            sock.close()
            raise ConnectionError(f"auth handshake failed: {e}") from e
        return sock, fkey

    # -- incoming ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped:
            # snapshot under the lock (shutdown() swaps it to None under
            # the same lock); accept() itself runs outside the lock
            with self._lock:
                listener = self._listener
            if listener is None:
                return
            try:
                sock, peer = listener.accept()
            except OSError as e:
                with self._lock:
                    gone = self._listener is None
                if self._stopped or gone:
                    return
                # transient accept failure (ECONNABORTED, EMFILE burst)
                # must not kill the acceptor
                self._dout(1, f"accept error, retrying: {e}")
                time.sleep(0.01)
                continue
            threading.Thread(  # noqa: CL13 — fire-and-forget by design: a handshake either promotes into a reader (reaped via mark_down) or closes its socket and exits
                target=self._handshake_incoming, args=(sock, peer), daemon=True
            ).start()

    def _handshake_incoming(self, sock: socket.socket, peer) -> None:
        try:
            sock.settimeout(self.cct.conf.get("ms_connect_timeout") if self.cct else 10.0)
            banner = self._read_exact(sock, len(_BANNER))
            if banner != _BANNER:
                sock.close()
                return
            ident = self._read_line(sock)
            sock.settimeout(None)
        except (OSError, ConnectionError):
            sock.close()
            return
        try:
            peer_name, cid_str, policy = ident.split()
            connect_id = int(cid_str)
            if policy not in (POLICY_LOSSY, POLICY_LOSSLESS_PEER):
                raise ValueError(policy)
        except ValueError:
            sock.close()
            return
        fkey: bytes | None = None
        try:
            auth = self._authenticator()
        except Exception as e:
            # misconfigured secret on a cephx-required acceptor: reject
            # every peer loudly rather than failing open
            self._dout(0, f"auth misconfigured, rejecting {peer}: {e}")
            sock.close()
            return
        if self._auth_required():
            if auth is None:
                # cephx required but no secret: an acceptor cannot
                # validate proofs OR tickets — fail closed
                self._dout(0, f"cephx required but no secret; rejecting {peer}")
                sock.close()
                return
            try:
                sock.settimeout(
                    self.cct.conf.get("ms_connect_timeout") if self.cct else 10.0
                )
                snonce = auth.make_nonce()
                sock.sendall(
                    f"auth-challenge {snonce} {self.auth_service}\n".encode()
                )
                parts = self._read_line(sock, _AUTH_LINE_LIMIT).split()
                if not parts:
                    raise ConnectionError("empty auth reply")
                if parts[0] == "auth-proof" and len(parts) == 3:
                    _, proof, cnonce = parts
                    if not auth.verify(snonce, peer_name, proof):
                        raise ConnectionError(f"bad auth proof from {peer_name}")
                    sock.sendall(
                        f"auth-ok {auth.proof(cnonce, 'cluster')}\n".encode()
                    )
                    fkey = auth.session_key(snonce, cnonce)
                elif parts[0] == "auth-ticket" and len(parts) == 4:
                    _, blob, proof, cnonce = parts
                    gen = (self.auth_gen_provider() if self.auth_gen_provider
                           else 1)
                    t = validate_ticket(
                        auth.secret, self.auth_service, gen, blob
                    )
                    if t is None:
                        raise ConnectionError(
                            f"invalid/expired/rotated-out {self.auth_service} "
                            f"ticket from {peer_name}"
                        )
                    skey = bytes.fromhex(t["session_key"])
                    if t.get("entity") != peer_name or not _hmac.compare_digest(
                        proof_hex(skey, snonce, peer_name), proof
                    ):
                        raise ConnectionError(
                            f"ticket session-key proof failed for {peer_name}"
                        )
                    sock.sendall(
                        f"auth-ok {proof_hex(skey, cnonce, 'cluster')}\n"
                        .encode()
                    )
                    # mix both nonces: fresh frame key per incarnation
                    # (see the connector-side comment)
                    fkey = session_key_from_nonces(skey, snonce, cnonce)
                else:
                    raise ConnectionError(f"bad auth reply {parts[:1]}")
                sock.settimeout(None)
            except (OSError, ValueError, ConnectionError) as e:
                self._dout(1, f"auth reject {peer_name}@{peer}: {e}")
                sock.close()
                return
        with self._lock:
            sess = self._sessions.setdefault((peer_name, connect_id), _Session())
            conn = Connection(
                self, sock, peer, policy, outgoing=False, session=sess,
            )
            conn.peer_name = peer_name
            conn.connect_id = connect_id
            conn._frame_key = fkey
            self._conns[peer] = conn
            self._conns_by_name[peer_name] = conn
            if len(self._sessions) > 4096:
                self._evict_sessions_locked()
        self._start_reader(conn)

    def _evict_sessions_locked(self) -> None:
        # bound session-state memory without destroying the dedup state of
        # sessions that still have a live connection
        live = {id(c._session) for c in self._conns.values()}
        for key in list(self._sessions):
            if len(self._sessions) <= 2048:
                break
            if id(self._sessions[key]) not in live:
                del self._sessions[key]

    def _start_reader(self, conn: Connection) -> None:
        threading.Thread(  # noqa: CL13 — fire-and-forget by design: the read loop exits when its socket incarnation dies; shutdown reaps it via mark_down, not join
            target=self._read_loop, args=(conn, conn.sock),
            name=f"msgr-{self.name}-rx", daemon=True,
        ).start()

    def _read_loop(self, conn: Connection, sock: socket.socket) -> None:
        max_len = self.cct.conf.get("ms_max_frame_len") if self.cct else (1 << 28)
        # frame auth state is per socket incarnation: the key was set by
        # the handshake that produced `sock`, and the receive counter
        # starts at 0 exactly when the peer's send counter does
        fkey = conn._frame_key
        rx_ctr = 0
        if fkey is not None:
            from ..auth.cephx import frame_tag
        try:
            while not conn._closed and sock is conn.sock:
                hdr = self._read_exact(sock, 8)
                length, crc = struct.unpack("<II", hdr)
                if length > max_len or length < 1:
                    raise OSError(f"bad frame length ({length})")
                body = self._read_exact(sock, length)
                if crc32c(body) != crc:
                    raise OSError("frame crc mismatch")
                if fkey is not None:
                    tag = self._read_exact(sock, _TAG_LEN)
                    if not _hmac.compare_digest(
                        frame_tag(fkey, rx_ctr, body), tag
                    ):
                        # forged/tampered/replayed frame: connection-fatal
                        # (reference: ProtocolV2 signed-frame mismatch)
                        self._dout(
                            0, f"frame auth tag mismatch from {conn.peer_addr}"
                        )
                        raise OSError("frame auth tag mismatch")
                    rx_ctr += 1
                ftype, payload = body[0], body[1:]
                if ftype == _FRAME_ACK:
                    conn._handle_ack(struct.unpack("<Q", payload)[0])
                    continue
                if ftype == _FRAME_MSG_Z:
                    alen = payload[0]
                    algo = payload[1:1 + alen].decode()
                    (raw_len,) = struct.unpack_from("<I", payload,
                                                    1 + alen)
                    if raw_len > max_len or raw_len < 1:
                        # ms_max_frame_len bounds the INFLATED size too:
                        # a lying header cannot make us allocate beyond
                        # it (decompression-bomb guard)
                        raise OSError(
                            f"bad inflated frame length ({raw_len})")
                    comp = self._wire_decomp.get(algo)
                    if comp is None:
                        from ..compressor import Compressor

                        comp = self._wire_decomp[algo] = \
                            Compressor.create(algo)
                    z = payload[5 + alen:]
                    if not hasattr(comp, "decompress_bounded"):
                        # an unbounded inflate would defeat the bomb
                        # guard (the stream could exceed its declared
                        # size before any post-check): only algorithms
                        # with a bounded inflate may ride the wire
                        raise OSError(
                            f"wire compression {algo!r} lacks bounded "
                            f"inflate")
                    payload = comp.decompress_bounded(z, raw_len)
                    if len(payload) != raw_len:
                        raise OSError(
                            "inflated frame length mismatch "
                            f"({len(payload)} != declared {raw_len})")
                msg = decode_message(payload)
                if TRACER.enabled:  # one attribute check when off
                    t_id = getattr(msg, "trace_id", None)
                    if t_id is not None:
                        TRACER.tracepoint(
                            "msgr", "recv", entity=self.name,
                            trace_id=t_id, msg=type(msg).__name__,
                            peer=msg.src or conn.peer_name or None,
                        )
                if _registry().configured("msgr.frame.recv"):
                    try:
                        failpoint(
                            "msgr.frame.recv", cct=self.cct,
                            entity=self.name,
                            peer=msg.src or conn.peer_name or None,
                        )
                    except FailpointCrash:
                        # crash is CONNECTION-fatal here (the generic
                        # reader handler below absorbs it): one
                        # interpreter hosts many daemons, so there is no
                        # process to kill — docs/fault_injection.md
                        # documents this scoping
                        raise
                    except FailpointError:
                        # the frame vanishes in the "network": neither
                        # dispatched nor acked (the thrasher's netsplit
                        # primitive) — recovery, not replay, heals the gap
                        continue
                sess = conn._session
                # one incarnation at a time: see _Session.dispatch_lock
                with sess.dispatch_lock:
                    with sess.lock:
                        if conn._closed or sock is not conn.sock:
                            # socket was replaced/closed while we were blocked:
                            # this frame belongs to the dead incarnation
                            return
                        if msg.seq <= conn.in_seq:
                            conn._send_ack(conn.in_seq)  # re-ack dropped dup
                            continue
                        if not conn.peer_name:
                            conn.peer_name = msg.src
                    # dispatch OUTSIDE the session lock (reference: the
                    # DispatchQueue decoupling — fast_dispatch never holds
                    # connection locks): dispatchers take their own locks
                    # (monc::lock, osd::pg, ...) and daemon code sends —
                    # which takes session locks — while holding those, so an
                    # upcall under msgr::session is one half of an ABBA
                    # inversion lockdep aborts on.  This rx thread is the
                    # connection's only reader, so delivery order is
                    # untouched.  Dispatch BEFORE advancing in_seq / acking:
                    # if the dispatcher raises, the sender must keep its
                    # replay entry (an early ack would prune it and lose the
                    # message despite the lossless contract — advisor r1).
                    # A reconnect racing the dispatch replays the frame on
                    # the next incarnation, whose reader waits on the
                    # session's dispatch_lock and then finds the seq
                    # delivered.  And a DETERMINISTICALLY-failing handler must
                    # not reconnect-livelock the peer pair: after
                    # _POISON_RETRIES failed deliveries of the same seq the
                    # message is dropped-and-acked with a loud log.
                    try:
                        self._dispatch(conn, msg)
                    except Exception:
                        # the session outlives socket incarnations, so a
                        # replaced socket's rx thread can race this one on
                        # the poison counters — count under the lock
                        with sess.lock:
                            if sess.fail_seq == msg.seq:
                                sess.fail_count += 1
                            else:
                                sess.fail_seq, sess.fail_count = msg.seq, 1
                            fail_count = sess.fail_count
                        # Only an INCOMING conn earns a redelivery by dying:
                        # its dialer holds the unacked frame in _replay and
                        # resends on reconnect.  An outgoing conn receives
                        # replies; the acceptor side drops its replay when
                        # the socket dies, so killing the conn here would
                        # just blackhole the link (reviewer r2) — drop the
                        # message loudly and let protocol retries recover.
                        if not conn.outgoing and fail_count < _POISON_RETRIES:
                            raise  # kill conn; dialer redelivers on reconnect
                        self._dout(
                            0,
                            f"dropping poison message seq={msg.seq} "
                            f"({type(msg).__name__}) after "
                            f"{fail_count} failed dispatch(es)",
                        )
                    with sess.lock:
                        if conn.outgoing and (conn._closed or sock is not conn.sock):
                            # a reconnect restarted this session's receive
                            # seqs at 0 (_reconnect_and_replay): the frame
                            # belonged to the dead incarnation
                            return
                        # delivered: advance even if this incoming socket
                        # died mid-dispatch, so the replay of this seq on
                        # the next incarnation is dropped as a duplicate
                        conn.in_seq = msg.seq
                        if conn._closed:
                            return
                        if conn.policy == POLICY_LOSSLESS_PEER:
                            conn._send_ack(msg.seq)
        except OSError:
            pass
        except Exception as e:
            # decode failure / dispatcher exception: connection-fatal, like
            # ProtocolV2 treating an undecodable frame as protocol error
            self._dout(0, f"reader failed on {conn.peer_addr}: {e!r}")
        # reader died: an incoming lossless conn's peer will reconnect (new
        # socket, same session); an outgoing lossless conn repairs the
        # session NOW if unacked frames remain — frames written to a socket
        # that died in flight would otherwise only be replayed when the
        # *next* send fails, which may never come.  Only lossy resets
        # surface to the dispatcher.
        if conn._closed or sock is not conn.sock:
            return
        if conn.policy == POLICY_LOSSLESS_PEER:
            if not conn.outgoing:
                conn.mark_down()
                return
            with conn._lock:
                if conn._closed or sock is not conn.sock or not conn._replay:
                    return
                try:
                    conn._reconnect_and_replay()
                except ConnectionError:
                    if not self._stopped:
                        for d in self.dispatchers:
                            d.ms_handle_reset(conn)
            return
        was_open = not conn._closed
        conn.mark_down()
        if was_open and not self._stopped:
            for d in self.dispatchers:
                d.ms_handle_reset(conn)

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise OSError("connection closed")
            buf += chunk
        return buf

    def _dispatch(self, conn: Connection, msg: Message) -> None:
        for d in self.dispatchers:
            if d.ms_dispatch(conn, msg):
                return

    def get_connection(self, peer_name: str) -> Connection | None:
        """Latest live incoming connection from a named peer (reference:
        Messenger tracks connections per entity)."""
        with self._lock:
            conn = self._conns_by_name.get(peer_name)
            return conn if conn is not None and conn.is_connected else None

    def _forget(self, conn: Connection) -> None:
        with self._lock:
            if self._conns.get(conn.peer_addr) is conn:
                del self._conns[conn.peer_addr]
            if self._conns_by_name.get(conn.peer_name) is conn:
                del self._conns_by_name[conn.peer_name]
