"""MonClient — daemon/client session to the monitor quorum (reference:
src/mon/MonClient.{h,cc}; SURVEY.md §2.5).

Hunts for a live mon, redials to the leader when a command is NACKed with
`not leader`, keeps the OSDMap subscription alive across reconnects, and
exposes `wait_for_osdmap` the way daemons block on map epochs.
"""
from __future__ import annotations

import threading
import time

from ..common.lockdep import make_lock
from ..msg import Dispatcher, Messenger
from ..osd.osdmap import OSDMap
from .messages import (
    MMonCommand,
    MMonCommandAck,
    MMonSubscribe,
    MOSDAlive,
    MOSDBoot,
    MOSDFailure,
    MOSDMapMsg,
)


class MonClient(Dispatcher):
    def __init__(self, cct, mon_addrs: list[tuple[str, int]], name: str | None = None):
        self.cct = cct
        self.mon_addrs = [tuple(a) for a in mon_addrs]
        self.messenger = Messenger.create(cct, name or cct.name)
        self.messenger.add_dispatcher(self)
        self._conn = None
        self._conn_addr: tuple[str, int] | None = None
        self._lock = make_lock("monc::lock")
        self._cond = threading.Condition(self._lock)
        self._tid = 0
        # random per-process session id: part of the monitor's command
        # dedup key so two clients with the same entity name don't collide
        import uuid

        self._session = uuid.uuid4().hex
        self._acks: dict[int, tuple[int, object]] = {}
        self._last_failed_hunt = float("-inf")
        self._hunting = False
        self.osdmap: OSDMap | None = None
        self._subscribed_from = 0
        self._map_callbacks: list = []

    # -- connection hunt ---------------------------------------------------
    def _connect(self, addr=None):
        with self._lock:
            if addr is None and self._conn is not None and self._conn.is_connected:
                return self._conn
            addrs = [addr] if addr else list(self.mon_addrs)
        # the dial + subscription renewal run OUTSIDE monc::lock: the
        # messenger dispatches incoming frames while holding
        # msgr::session and ms_dispatch then takes monc::lock, so
        # calling into the messenger with monc::lock held is the ABBA
        # inversion lockdep (rightly) aborts.  Concurrent dials are
        # harmless — last one wins the cache and the rest stay usable.
        last_err = None
        for a in addrs:
            try:
                conn = self.messenger.connect(tuple(a))
                # a mon that dies between accept and this send must
                # fail over to the next address like a refused dial
                self._renew_sub(conn)
            except (OSError, ConnectionError) as e:
                last_err = e
                continue
            with self._lock:
                self._conn, self._conn_addr = conn, tuple(a)
            return conn
        raise ConnectionError(f"no monitor reachable: {last_err}")

    def _renew_sub(self, conn) -> None:
        """(Re-)arm the osdmap subscription on a connection; idempotent on
        the mon side, shared by dial/subscribe/wait paths."""
        if self._subscribed_from:
            conn.send_message(
                MMonSubscribe(what={"osdmap": self._subscribed_from})
            )

    def ms_handle_reset(self, conn) -> None:
        with self._lock:
            if conn is self._conn:
                self._conn = None

    def ensure_connection(self) -> None:
        """Re-dial the quorum if the subscription connection died.  The
        osdmap subscription is PUSH-based: a mon that crashes between
        pushes leaves an idle subscriber on a stale map forever unless
        something re-hunts — daemons call this from their tick loop.
        Never blocks: the hunt runs on a helper thread (a full-quorum
        dial can eat whole connect timeouts, and the caller's tick loop
        drives heartbeats that must keep their cadence), rate-limited
        after failures.  The state check itself is a TRY-acquire so a
        busy client op can never stall the tick loop here."""
        if not self._lock.acquire(blocking=False):
            return  # a hunt (or another client op) is busy; next tick
        try:
            if self._conn is not None and self._conn.is_connected:
                return
            now = time.monotonic()
            if self._hunting or now - self._last_failed_hunt < 2.0:
                return
            self._hunting = True
        finally:
            self._lock.release()

        def _hunt() -> None:
            try:
                self._connect()
            except (OSError, ConnectionError):
                with self._lock:
                    self._last_failed_hunt = time.monotonic()
            finally:
                with self._lock:
                    self._hunting = False

        threading.Thread(  # noqa: CL13 — fire-and-forget by design: the _hunting flag dedups to one live hunt and it self-terminates on connect or deadline
            target=_hunt, name=f"{self.messenger.name}-mon-hunt", daemon=True
        ).start()

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MMonCommandAck):
            with self._lock:
                self._acks[msg.tid] = (msg.retval, msg.result)
                self._cond.notify_all()
            return True
        if isinstance(msg, MOSDMapMsg):
            newest = None
            for _e, j in sorted(msg.maps.items(), key=lambda kv: int(kv[0])):
                newest = j
            if newest is not None:
                m = OSDMap.from_json(newest, device=self.cct.device)
                callbacks = []
                with self._lock:
                    if self.osdmap is None or m.epoch > self.osdmap.epoch:
                        self.osdmap = m
                        self._subscribed_from = m.epoch + 1
                        callbacks = list(self._map_callbacks)
                        self._cond.notify_all()
                for cb in callbacks:
                    cb(m)
            return True
        return False

    # -- commands ----------------------------------------------------------
    def fetch_config(self, cct, who: str | None = None) -> int:
        """Boot-time central config pull (reference: the mon config db
        pushed at MAuth/MConfig time): fetch this entity's merged view
        and apply it at LEVEL_MON, so file/override settings still
        win.  Returns the number of options applied; mon unreachable
        or empty db is not an error — local config stands."""
        from ..common.config import LEVEL_MON

        who = who or cct.conf.get("name")
        try:
            rv, res = self.command({"prefix": "config get", "who": who},
                                   timeout=5.0)
        except Exception:
            return 0
        if rv != 0 or not isinstance(res, dict):
            return 0
        n = 0
        for name, value in res.items():
            try:
                cct.conf.set(name, value, level=LEVEL_MON)
                n += 1
            except (KeyError, ValueError) as e:
                cct.dout("monc", 2,
                         f"central config {name}={value!r} rejected: "
                         f"{e}")
        return n

    def command(self, cmd: dict, timeout: float = 10.0) -> tuple[int, object]:
        """Send a CLI-style command; transparently follows the leader
        (reference: MonClient command routing + Objecter retries)."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        wait = min(deadline, 10.0)
        # Five sends may go unanswered.  An election or a quorum still
        # syncing answers at once (-307 naming no other leader, -11), so
        # counting those NACKs would give up within a second: they are
        # waited out instead, up to the time five unanswered sends take.
        unanswered = 0
        give_up = time.monotonic() + 5 * wait
        addr = None
        # one tid for every attempt of this logical command: the monitor
        # dedups on (src, session, tid), so a retry after a lost ack
        # re-fetches the recorded result instead of re-executing a
        # non-idempotent command
        with self._lock:
            self._tid += 1
            tid = self._tid
        while unanswered < 5 and time.monotonic() < give_up:
            try:
                conn = self._connect(addr)
                asked = self._conn_addr
                conn.send_message(
                    MMonCommand(tid=tid, cmd=cmd, session=self._session)
                )
            except (OSError, ConnectionError):
                unanswered += 1
                addr = None
                continue
            with self._lock:
                ok = self._cond.wait_for(lambda: tid in self._acks, timeout=wait)
                if not ok:
                    unanswered += 1
                    addr = None
                    continue
                retval, result = self._acks.pop(tid)
            if retval == -307 and isinstance(result, dict):
                # peon: redial the leader it names
                la = result.get("leader_addr")
                addr = tuple(la) if la else None
                if addr is None or addr == asked:
                    # electing: it names no leader, or itself (a leader
                    # that has called an election keeps its rank)
                    addr = None
                    time.sleep(0.2)
                continue
            if retval == -11:  # EAGAIN: leader elected, state still syncing
                time.sleep(0.2)
                continue
            return retval, result
        return -110, "command timed out (no leader?)"

    # -- subscriptions -----------------------------------------------------
    def subscribe_osdmap(self, from_epoch: int = 1, callback=None) -> None:
        with self._lock:
            self._subscribed_from = max(self._subscribed_from, from_epoch) or 1
            if callback is not None:
                self._map_callbacks.append(callback)
        # _connect renews only on a fresh dial; renew explicitly in case a
        # cached connection predates the subscription
        self._renew_sub(self._connect())

    def wait_for_osdmap(self, min_epoch: int = 1, timeout: float = 10.0) -> OSDMap:
        """Block until a map >= min_epoch arrives, actively hunting: if the
        mon connection resets (mon restart, lossy drop, mid-election
        hiccup) the subscription is re-armed on a fresh dial instead of
        waiting out the timeout on a dead session (reference: MonClient's
        hunt + renew on reset)."""
        deadline = time.monotonic() + timeout

        def have_map() -> bool:
            return self.osdmap is not None and self.osdmap.epoch >= min_epoch

        while True:
            with self._lock:
                if self._cond.wait_for(
                    have_map, timeout=min(1.0, max(0.0, deadline - time.monotonic()))
                ):
                    return self.osdmap
                expired = time.monotonic() >= deadline
            if expired:
                have = self.osdmap.epoch if self.osdmap else None
                raise TimeoutError(
                    f"no osdmap epoch >= {min_epoch} (have {have})"
                )
            # not served yet: re-dial if the connection died — the fresh
            # dial re-arms the subscription.  A live connection needs no
            # nudge (re-sending the sub every slice would make the mon
            # push the full map once per second per waiting daemon).
            try:
                self._connect()
            except (OSError, ConnectionError):
                pass

    # -- daemon helpers ----------------------------------------------------
    def send_boot(self, osd: int, addr: tuple[str, int]) -> None:
        self._connect().send_message(
            MOSDBoot(osd=osd, host=addr[0], port=addr[1])
        )

    def report_failure(self, target: int, failed_for: float = 0.0) -> None:
        try:
            self._connect().send_message(
                MOSDFailure(target=target, failed_for=failed_for, reporter=None)
            )
        except (OSError, ConnectionError):
            pass

    def report_alive(self, target: int) -> None:
        """Retract an earlier report_failure for `target` (reference:
        OSD::send_still_alive -> MOSDAlive): the mon discards this
        daemon's entry from the target's corroboration set.  reporter
        is left None — the receiving mon pins it from msg.src, which
        survives the peon→leader forward."""
        try:
            self._connect().send_message(
                MOSDAlive(target=target, reporter=None)
            )
        except (OSError, ConnectionError):
            pass

    def shutdown(self) -> None:
        self.messenger.shutdown()
