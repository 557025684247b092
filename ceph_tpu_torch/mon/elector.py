"""Monitor elections (reference: src/mon/Elector.{h,cc} — lowest rank in
the quorum wins; epoch odd while electing, even once stable).

Propose/ack/victory over the messenger: a mon proposes with a bumped
epoch; peers of higher rank ack (deferring), peers of lower rank counter-
propose.  The proposer declares victory once every monmap member acked or
a majority acked and the election timer expired.
"""
from __future__ import annotations

import threading

from ..common.failpoint import FailpointCrash, FailpointError, failpoint
from ..common.lockdep import make_lock
from .messages import MMonElection


class Elector:
    def __init__(self, mon, timeout: float = 0.3):
        self.mon = mon
        self.timeout = timeout
        self.epoch = 1
        self._acks: set[int] = set()
        self._electing = False
        # True while we are deferring to a lower-ranked proposer: our own
        # proposal is dead, so acks must not accumulate and a timeout must
        # RE-PROPOSE, never declare victory
        self._deferred = False
        self._timer: threading.Timer | None = None
        #: the rank elected at `epoch`, once a victory is declared or heard
        self._victor: int | None = None
        self._lock = make_lock("mon::elector")

    def stop(self) -> None:
        with self._lock:
            self._electing = False
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def start_election(self) -> None:
        """reference: Elector::start — propose ourselves."""
        try:
            # "mon.election.start": delay holds this mon's proposal back
            # (higher ranks win the round); error suppresses it entirely
            # (getattr: unit tests drive the elector with bare stub mons)
            failpoint("mon.election.start",
                      cct=getattr(self.mon, "cct", None),
                      entity=f"mon.{getattr(self.mon, 'name', self.mon.rank)}")
        except FailpointCrash:
            raise
        except FailpointError:
            return
        with self._lock:
            if getattr(self, "_stopped", False):
                return
            if self.epoch % 2 == 0:
                self.epoch += 1  # odd = electing
            else:
                self.epoch += 2
            self._electing = True
            self._deferred = False
            self._victor = None
            self._acks = {self.mon.rank}
            self.mon.set_electing()
            for r in self.mon.other_ranks():
                self.mon.send_mon(
                    r, MMonElection(op="propose", epoch=self.epoch, rank=self.mon.rank)
                )
            self._arm_timer()
            self._maybe_win_locked()

    def _arm_timer(self, factor: float = 1.0) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self.timeout * factor, self._election_timeout)
        self._timer.daemon = True
        self._timer.start()

    def _election_timeout(self) -> None:
        with self._lock:
            if not self._electing:
                return
            if not self._deferred and len(self._acks) >= self.mon.majority():
                self._declare_victory_locked()
            else:
                # couldn't form a quorum, or we were deferring to a
                # proposer that went silent: a deferred mon's proposal is
                # dead, so it RE-PROPOSES — it never declares victory
                self._electing = False
                self.start_election()

    def _maybe_win_locked(self) -> None:
        if self._electing and len(self._acks) >= len(self.mon.monmap.ranks()):
            self._declare_victory_locked()

    def _declare_victory_locked(self) -> None:
        self._electing = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self.epoch += 1  # even = stable
        self._victor = self.mon.rank
        quorum = sorted(self._acks)
        for r in self.mon.other_ranks():
            self.mon.send_mon(
                r,
                MMonElection(
                    op="victory", epoch=self.epoch, rank=self.mon.rank,
                    quorum=quorum,
                ),
            )
        self.mon.win_election(self.epoch, quorum)

    def handle(self, conn, msg: MMonElection) -> None:
        if msg.op == "propose":
            self._handle_propose(msg)
        elif msg.op == "ack":
            self._handle_ack(msg)
        elif msg.op == "victory":
            self._handle_victory(msg)

    def _handle_propose(self, msg: MMonElection) -> None:
        with self._lock:
            was_electing = self._electing
            if msg.epoch > self.epoch:
                self.epoch = msg.epoch
                self._victor = None
            if msg.rank < self.mon.rank:
                # defer to the lower rank (reference: Elector::defer); keep
                # a timer armed so a proposer that dies mid-election leaves
                # us retrying, not stranded — but MUCH longer than the
                # proposer's victory timer, else our re-propose races its
                # victory and elections livelock (epoch churn forever).
                # Forget any acks from our own abandoned proposal: a defer
                # timeout must RE-PROPOSE, never declare victory on a dead
                # election's ack set (a deferring mon that still held a
                # majority of stale acks would steal leadership from the
                # lower rank whenever the victory message was slow)
                self._electing = True
                self._deferred = True
                self._acks = {self.mon.rank}
                self.mon.set_electing()
                self._arm_timer(factor=5.0)
                self.mon.send_mon(
                    msg.rank,
                    MMonElection(op="ack", epoch=msg.epoch, rank=self.mon.rank),
                )
            elif not was_electing:
                # we outrank the proposer and have no election running:
                # counter-propose.  If one IS running, our earlier propose
                # stands — re-proposing on every higher-rank propose makes
                # boot-time elections storm (epoch churn, overlapping
                # leader_inits) instead of converging.
                self.start_election()

    def _handle_ack(self, msg: MMonElection) -> None:
        with self._lock:
            # acks addressed to a proposal we abandoned by deferring must
            # not accumulate — _maybe_win_locked would declare victory on
            # a dead election once every rank's late ack trickled in
            if not self._electing or self._deferred or msg.epoch != self.epoch:
                return
            self._acks.add(msg.rank)
            self._maybe_win_locked()

    def _handle_victory(self, msg: MMonElection) -> None:
        with self._lock:
            if msg.epoch < self.epoch:
                return
            if msg.epoch == self.epoch and self._victor not in (None, msg.rank):
                # two victories at one epoch: a proposal was lost on its way
                # to a mon not up yet, and a third mon acked both proposers.
                # Following the other victor would leave each leader a peon
                # of the other and the cluster with none; elect again.
                self._electing = False
                self.start_election()
                return
            self.epoch = msg.epoch
            self._victor = msg.rank
            self._electing = False
            self._deferred = False
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        self.mon.lose_election(msg.epoch, msg.rank, msg.quorum or [])
