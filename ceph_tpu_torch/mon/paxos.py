"""Single-decree Paxos replicating the mon KV store (reference:
src/mon/Paxos.{h,cc}; SURVEY.md §2.5 "Paxos: single-decree Paxos
replicating MonitorDBStore").

One value is chosen at a time (version = last_committed + 1); a value is a
KV batch (JSON: {"ops": [[op, key, value_b64], ...]}) applied to the mon
store on commit.  Phases map to the reference's:

    leader_init → collect(pn) → peons reply last(pn, lc, uncommitted)
    propose     → begin(pn, v, value) → peons accept → commit broadcast

Recovery matches the reference's semantics: a collect learns any value
accepted under an older pn and re-proposes it; peons that fall behind ask
for a sync of missed commits (op=sync_req) instead of accepting a gap.
Leases are simplified away: reads are served by the leader only, and a
quorum change always runs a fresh collect.
"""
from __future__ import annotations

import base64
import json
import threading

from ..common.failpoint import FailpointCrash, FailpointError, failpoint
from ..common.lockdep import make_lock
from ..store.kv import Batch
from .messages import MMonPaxos


def _reply(conn, msg, fsid=None) -> None:
    if fsid is not None:
        msg.fsid = fsid
    try:
        conn.send_message(msg)
    except (OSError, ConnectionError):
        pass  # peer reset; election/timeout machinery recovers


_K_LAST = "paxos:last_committed"
_K_PN = "paxos:accepted_pn"
_K_UNCOMMITTED = "paxos:uncommitted"


def _txn_key(version: int) -> str:
    return f"paxos:txn:{version:012d}"


def encode_value(ops: list[tuple[int, str, bytes]]) -> str:
    return json.dumps(
        {"ops": [[op, key, base64.b64encode(val).decode()] for op, key, val in ops]}
    )


def decode_value(value: str) -> list[tuple[int, str, bytes]]:
    return [
        (op, key, base64.b64decode(val))
        for op, key, val in json.loads(value)["ops"]
    ]


class Paxos:
    """Runs inside a Monitor; the monitor routes MMonPaxos to handle()."""

    def __init__(self, mon, store):
        self.mon = mon  # provides rank, majority, other_ranks, send_mon, on_paxos_commit
        self.store = store
        self.last_committed = int(store.get(_K_LAST) or b"0")
        self.accepted_pn = int(store.get(_K_PN) or b"0")
        self._lock = make_lock("mon::paxos")
        self._cond = threading.Condition(self._lock)
        # leader state
        self.pn = 0
        self._collect_acks: set[int] = set()
        self._accept_acks: set[int] = set()
        self._proposing = False
        self._learned: dict[int, tuple[int, str]] = {}  # rank -> (v, value)
        # per-proposal instance id echoed in accepts: a late accept for an
        # aborted proposal under the same (pn, version) must not count
        # toward a different value (advisor r1 finding)
        self._propose_nonce = 0
        # an aborted (timed-out) proposal may have been accepted by a
        # minority; the next proposal must run a fresh collect under a new
        # pn (reference: Paxos re-bootstraps) instead of reusing the pn
        self._need_collect = False

    # -- helpers ----------------------------------------------------------
    def _apply(self, version: int, value: str) -> None:
        # "mon.paxos.commit": an error here is a crash BEFORE the commit
        # lands in the store — the accepted-but-uncommitted value stays
        # on disk and the next collect round must recover it (the paxos
        # crash-recovery replay path)
        failpoint("mon.paxos.commit",
                  cct=getattr(self.mon, "cct", None),
                  entity=f"mon.{getattr(self.mon, 'name', self.mon.rank)}",
                  version=version)
        batch = Batch()
        for op, key, val in decode_value(value):
            if op == 1:
                batch.set(key, val)
            else:
                batch.rm(key)
        batch.set(_txn_key(version), value.encode())
        batch.set(_K_LAST, str(version).encode())
        batch.rm(_K_UNCOMMITTED)
        self.store.submit_batch(batch)
        self.last_committed = version
        self.mon.on_paxos_commit(version)

    def _uncommitted(self) -> tuple[int, int, str] | None:
        """(accepted_pn, version, value) of the locally-accepted-but-
        uncommitted proposal, if any."""
        raw = self.store.get(_K_UNCOMMITTED)
        if not raw:
            return None
        d = json.loads(raw.decode())
        return d.get("pn", 0), d["version"], d["value"]

    def _store_uncommitted(self, version: int, value: str, pn: int) -> None:
        self.store.set(
            _K_UNCOMMITTED,
            json.dumps({"version": version, "value": value, "pn": pn}).encode(),
        )

    # -- leader: recovery round -------------------------------------------
    def leader_init(self, timeout: float = 5.0) -> bool:
        """Collect phase after winning an election (reference:
        Paxos::leader_init + collect)."""
        ok, best = self._collect(timeout)
        if not ok:
            return False
        if best is not None and best[1] == self.last_committed + 1:
            self._propose_locked_value(best[2])
        return True

    def _collect(self, timeout: float) -> tuple[bool, tuple | None]:
        """One collect round under a fresh pn.  Returns (ok, best) where
        best is the (pn, version, value) accepted under the highest pn at
        the next slot, or None."""
        with self._lock:
            self.pn = (self.accepted_pn // 100 + 1) * 100 + self.mon.rank
            self.accepted_pn = self.pn
            self.store.set(_K_PN, str(self.pn).encode())
            self._collect_acks = {self.mon.rank}
            self._learned = {}
            self._need_collect = False
            # send to every monmap member, not just the election quorum: a
            # mon whose election ack arrived late is outside `quorum` but
            # must still receive paxos traffic or it stays stale forever
            # (advisor r1 high finding)
            for r in self.mon.other_ranks():
                self.mon.send_mon(
                    r,
                    MMonPaxos(
                        op="collect", pn=self.pn,
                        last_committed=self.last_committed,
                    ),
                )
            ok = self._cond.wait_for(
                lambda: len(self._collect_acks) >= self.mon.majority(),
                timeout=timeout,
            )
            if not ok:
                self._need_collect = True
                return False, None
            # adopt the value accepted under the HIGHEST pn at the next
            # slot (Paxos: same-version values from different aborted
            # rounds are tie-broken by pn, not arrival order), then
            # re-propose it under our pn
            best = self._uncommitted()
            for got in self._learned.values():
                if got[1] == self.last_committed + 1 and (
                    best is None or got[0] >= best[0]
                ):
                    best = got
            if best is not None and best[1] != self.last_committed + 1:
                best = None
            return True, best

    # -- leader: proposal --------------------------------------------------
    def propose(self, ops: list[tuple[int, str, bytes]], timeout: float = 5.0) -> bool:
        """Replicate one KV batch; blocks until commit or timeout.
        (reference: Paxos::propose_pending / begin)"""
        return self._propose_locked_value(encode_value(ops), timeout)

    def _propose_locked_value(self, value: str, timeout: float = 5.0) -> bool:
        try:
            # "mon.paxos.propose": error refuses the proposal (callers
            # see the same -110 a timed-out quorum produces); delay
            # stretches the commit latency
            failpoint("mon.paxos.propose",
                      cct=getattr(self.mon, "cct", None),
                      entity=f"mon.{getattr(self.mon, 'name', self.mon.rank)}")
        except FailpointCrash:
            raise
        except FailpointError:
            return False
        with self._lock:
            # serialize proposals (reference: one in-flight proposal)
            ok = self._cond.wait_for(lambda: not self._proposing, timeout=timeout)
            if not ok:
                return False
            self._proposing = True
            try:
                # an aborted predecessor may have been accepted by a
                # minority under the current pn; Paxos safety forbids
                # reusing that pn for a different value at the same slot.
                # Re-collect under a fresh pn and re-propose its value
                # first.  Checked INSIDE the _proposing slot so a
                # concurrent proposer can't slip past the flag (reviewer
                # r2 finding).
                while self._need_collect:
                    ok, best = self._collect(timeout)
                    if not ok:
                        return False
                    if best is not None and best[1] == self.last_committed + 1:
                        if not self._begin_round_locked(best[2], timeout):
                            return False
                return self._begin_round_locked(value, timeout)
            finally:
                self._proposing = False
                self._cond.notify_all()

    def _begin_round_locked(self, value: str, timeout: float) -> bool:
        """One begin→accept-majority→commit round.  Caller holds _lock and
        the _proposing slot."""
        version = self.last_committed + 1
        self._store_uncommitted(version, value, self.pn)
        self._accept_acks = {self.mon.rank}
        self._propose_version = version
        self._propose_nonce += 1
        nonce = self._propose_nonce
        for r in self.mon.other_ranks():
            self.mon.send_mon(
                r,
                MMonPaxos(
                    op="begin", pn=self.pn, version=version,
                    value=value, nonce=nonce,
                ),
            )
        ok = self._cond.wait_for(
            lambda: len(self._accept_acks) >= self.mon.majority(),
            timeout=timeout,
        )
        if not ok:
            self._need_collect = True
            return False
        try:
            self._apply(version, value)
        except Exception:
            # failure (injected or real) between majority-accept and the
            # local commit: the value IS chosen but not applied here.
            # Reusing this pn for a different value at the same slot
            # would break Paxos safety, so the next proposal must
            # re-collect under a fresh pn and re-drive the chosen value.
            self._need_collect = True
            raise
        for r in self.mon.other_ranks():
            self.mon.send_mon(
                r, MMonPaxos(op="commit", version=version, value=value)
            )
        return True

    # -- message handling (both roles) ------------------------------------
    def handle(self, conn, msg: MMonPaxos) -> None:
        op = msg.op
        if op == "collect":
            self._handle_collect(conn, msg)
        elif op == "last":
            self._handle_last(msg)
        elif op == "begin":
            self._handle_begin(conn, msg)
        elif op == "accept":
            self._handle_accept(msg)
        elif op == "commit":
            self._handle_commit(conn, msg)
        elif op == "sync_req":
            self._handle_sync_req(conn, msg)

    def _handle_collect(self, conn, msg: MMonPaxos) -> None:
        with self._lock:
            if msg.pn <= self.accepted_pn:
                return  # stale proposer; ignore (it will time out)
            self.accepted_pn = msg.pn
            self.store.set(_K_PN, str(msg.pn).encode())
            unc = self._uncommitted()
            reply = MMonPaxos(
                op="last", pn=msg.pn, last_committed=self.last_committed,
                uncommitted=(
                    {"pn": unc[0], "version": unc[1], "value": unc[2]}
                    if unc else None
                ),
            )
            # share commits the new leader is missing (reference: the
            # collect handler sending committed versions)
            missing = {}
            for v in range(msg.last_committed + 1, self.last_committed + 1):
                raw = self.store.get(_txn_key(v))
                if raw is not None:
                    missing[str(v)] = raw.decode()
            reply.value = missing or None
        _reply(conn, reply, self.mon.monmap.fsid)

    def _handle_last(self, msg: MMonPaxos) -> None:
        with self._lock:
            if msg.pn != self.pn:
                return
            # absorb commits we missed while not leader
            if msg.value:
                for v_str in sorted(msg.value, key=int):
                    v = int(v_str)
                    if v == self.last_committed + 1:
                        self._apply(v, msg.value[v_str])
            rank = self.mon.rank_of(msg.src)
            if msg.uncommitted and rank is not None:
                self._learned[rank] = (
                    msg.uncommitted.get("pn", 0),
                    msg.uncommitted["version"],
                    msg.uncommitted["value"],
                )
            if rank is not None:
                self._collect_acks.add(rank)
            self._cond.notify_all()

    def _handle_begin(self, conn, msg: MMonPaxos) -> None:
        with self._lock:
            if msg.pn < self.accepted_pn:
                return
            if msg.version != self.last_committed + 1:
                # we're behind: ask for the missed commits instead of
                # accepting a gap
                _reply(
                    conn,
                    MMonPaxos(op="sync_req", last_committed=self.last_committed),
                    self.mon.monmap.fsid,
                )
                return
            self.accepted_pn = msg.pn
            self._store_uncommitted(msg.version, msg.value, msg.pn)
        _reply(
            conn,
            MMonPaxos(op="accept", pn=msg.pn, version=msg.version, nonce=msg.nonce),
            self.mon.monmap.fsid,
        )

    def _handle_accept(self, msg: MMonPaxos) -> None:
        with self._lock:
            # (pn, version, nonce) must all match: a late accept for an
            # aborted proposal (same pn+version, different value) must not
            # count toward the current one
            if (
                msg.pn != self.pn
                or msg.version != getattr(self, "_propose_version", None)
                or msg.nonce != self._propose_nonce
            ):
                return
            rank = self.mon.rank_of(msg.src)
            if rank is not None:
                self._accept_acks.add(rank)
            self._cond.notify_all()

    def _handle_commit(self, conn, msg: MMonPaxos) -> None:
        with self._lock:
            if msg.version == self.last_committed + 1:
                self._apply(msg.version, msg.value)
            elif msg.version > self.last_committed:
                _reply(
                    conn,
                    MMonPaxos(op="sync_req", last_committed=self.last_committed),
                    self.mon.monmap.fsid,
                )

    def _handle_sync_req(self, conn, msg: MMonPaxos) -> None:
        with self._lock:
            versions = range(msg.last_committed + 1, self.last_committed + 1)
            txns = [
                (v, self.store.get(_txn_key(v))) for v in versions
            ]
        for v, raw in txns:
            if raw is not None:
                _reply(
                    conn,
                    MMonPaxos(op="commit", version=v, value=raw.decode()),
                    self.mon.monmap.fsid,
                )
