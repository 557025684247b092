"""mClock op scheduler — QoS-tagged dispatch (reference:
src/osd/scheduler/mClockScheduler.{h,cc} wrapping the dmclock library;
SURVEY.md §2.3).

Each op class holds (reservation, weight, limit) in ops/sec.  Ops get
three tags at enqueue:

    R = max(now, prev_R + 1/reservation)   # guaranteed minimum
    L = max(now, prev_L + 1/limit)         # hard ceiling
    P = max(prev_P, now) + 1/weight        # proportional share

Dequeue (mClock's two phases): first any class whose R tag is due — pick
the earliest R (reservations are guarantees, served before everything);
otherwise among classes whose L tag is due pick the earliest P tag
(weighted fair sharing under the ceiling).  If nothing is eligible the
caller sleeps until the earliest tag matures — including the RESERVATION
tag of a limit-gated class, since a due reservation is served regardless
of the ceiling (a limit-gated class's wake used to consider only its L
tag, so reservations were honored only at the caller's poll cadence).

The OSD instantiates the reference's three classes — client,
background_recovery, background_scrub — and (cephqos) grows the client
side DYNAMICALLY: one class per (client entity, pool) identity, keyed by
the cephmeter accounting labels.  Dynamic classes are bounded
(``max_dynamic``): registering one past the bound retires the
least-recently-enqueued dynamic class into the ``_default_`` catch-all —
its queued ops are spliced into ``_default_`` in arrival order and its
served/wait stats fold into a ``_retired_`` aggregate, so work and
counts are conserved, only per-client attribution is lost (the same
fold rule as the accounting table's ``_other_``).  A retired client
that returns simply re-registers with fresh tags (dmclock's idle-client
tag reset).  The mgr's QoS controller retunes per-class params at
runtime via :meth:`set_params` (docs/qos.md).

Observability: every class keeps queue depth, served-op count, and a
log2 wait histogram (enqueue -> dequeue).  :class:`SchedulerPerf`
duck-types ``PerfCounters`` so one ``cct.perf.add`` exports the rows as
labeled prometheus series (``ceph_mclock_*{qclass=...}``) through the
existing perf dump -> MMgrReport pipeline, with the exposition-time
``_fold_labeled_rows`` cardinality guard — exactly the cephmeter
precedent.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..common.io_accounting import _hist_add, _hist_merge, _new_hist
from ..common.lockdep import make_lock

#: the catch-all class retired dynamic clients fold into (and the class
#: ops of an unknown dynamic identity land in)
DEFAULT_CLASS = "_default_"
#: the labeled row every retired class's stats fold into
RETIRED_KEY = "_retired_"


@dataclass(frozen=True)
class QoSParams:
    """reference: dmclock ClientInfo (reservation, weight, limit);
    0 = none (no floor / no ceiling)."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0


@dataclass
class _ClassState:
    params: QoSParams
    queue: list = field(default_factory=list)  # FIFO of (seq, enq_ts, item)
    r_tag: float = 0.0
    p_tag: float = 0.0
    l_tag: float = 0.0
    dynamic: bool = False
    served: int = 0
    wait: dict = field(default_factory=_new_hist)  # enqueue->dequeue seconds


class MClockScheduler:
    def __init__(self, classes: dict[str, QoSParams],
                 clock=time.monotonic, max_dynamic: int = 0,
                 dynamic_params: QoSParams | None = None,
                 client_slots: int = 0):
        """``classes`` are the static classes (never retired).  When
        ``max_dynamic`` > 0 the per-client side is armed: a
        ``_default_`` catch-all is created and :meth:`client_class`
        registers/touches per-client classes under the bound.

        ``client_slots`` (> 0) bounds concurrent DYNAMIC-class op
        executions: a dynamic pick takes a slot ATOMICALLY with the
        dequeue (under the scheduler lock — no double-grant between
        two workers), and while all slots are busy dynamic classes
        are ineligible, so mClock's tags decide who runs next when
        the daemon is saturated — without the bound, an unbounded
        execution pool drains the queue instantly and the tags order
        nothing.  The executor MUST call :meth:`client_op_done` when
        a dynamic-class op finishes.  Static classes (background
        work, the internal "client" class forwarded OSD-to-OSD ops
        ride) are exempt, which keeps cross-OSD op forwarding
        deadlock-free.  0 = unbounded."""
        self._classes = {
            name: _ClassState(params) for name, params in classes.items()
        }
        self._clock = clock
        self._seq = 0
        self._lock = make_lock("osd::mclock")
        self._cond = threading.Condition(self._lock)
        self._stopped = False
        self.client_slots = max(0, int(client_slots))
        self._slots_busy = 0  # dynamic-class ops executing, under _lock
        self.max_dynamic = max(0, int(max_dynamic))
        self._dynamic_params = dynamic_params or QoSParams(weight=1.0)
        # LRU over dynamic classes: key -> None, oldest-touched first
        self._lru: OrderedDict[str, None] = OrderedDict()
        self._retired = 0
        self._retired_served = 0
        self._retired_wait = _new_hist()
        if self.max_dynamic > 0:
            st = _ClassState(self._dynamic_params)
            st.dynamic = True  # catch-all renders with the dynamic rows
            self._classes[DEFAULT_CLASS] = st

    # -- dynamic per-client classes (cephqos) -------------------------------
    def client_class(self, key: str) -> str:
        """Class name to enqueue a client op under: registers ``key`` as
        a dynamic class (LRU-retiring past the bound) and touches its
        LRU slot.  With the dynamic side unarmed returns the key's
        class only if it already exists statically, else ``client``."""
        with self._lock:
            if self.max_dynamic <= 0:
                return "client" if "client" in self._classes else key
            st = self._classes.get(key)
            if st is not None and st.dynamic and key != DEFAULT_CLASS:
                self._lru.move_to_end(key)
                return key
            if st is not None:
                return key  # a static name: never dynamic-register it
            self._register_dynamic_locked(key, self._dynamic_params)
            return key

    def _register_dynamic_locked(self, key: str, params: QoSParams) -> None:
        while len(self._lru) >= self.max_dynamic:
            # cephstorm: retiring the raw LRU head evicted classes with
            # QUEUED ops while idle (empty-queue) classes survived —
            # under hundreds of identities every eviction spliced live
            # work into _default_ and unattributed it (retirement
            # thrash).  Prefer the oldest-touched EMPTY class; only when
            # every dynamic class holds work does the true LRU head go.
            victim = next(
                (k for k in self._lru if not self._classes[k].queue),
                None,
            )
            self._retire_locked(
                victim if victim is not None else next(iter(self._lru)))
        st = _ClassState(params)
        st.dynamic = True
        now = self._clock()
        st.r_tag = st.p_tag = st.l_tag = now  # fresh cadence (idle reset)
        self._classes[key] = st
        self._lru[key] = None

    def _retire_locked(self, key: str) -> None:
        """Fold one dynamic class into the catch-all: queued ops splice
        into ``_default_`` in arrival (seq) order, stats fold into the
        ``_retired_`` aggregate — work and counts are conserved."""
        st = self._classes.pop(key)
        self._lru.pop(key, None)
        dflt = self._classes[DEFAULT_CLASS]
        if st.queue:
            was_empty = not dflt.queue
            dflt.queue = sorted(dflt.queue + st.queue)
            if was_empty:
                self._idle_reset_locked(dflt, self._clock())
            self._cond.notify_all()
        self._retired += 1
        self._retired_served += st.served
        _hist_merge(self._retired_wait, st.wait)

    def set_params(self, name: str, params: QoSParams,
                   register: bool = True) -> bool:
        """Retune one class's (reservation, weight, limit) — the QoS
        controller's scheduler-side knob.  With ``register`` (the
        default), unknown names register as dynamic classes (bounded,
        LRU like client_class); the OSD's controller-push handler
        passes ``register=False`` because the controller fans the SAME
        class map to every OSD — registering identities this OSD never
        serves would LRU-thrash its genuinely active classes.  Tags
        reset to now: a class whose old params left far-future tags
        must pick up the new cadence immediately, not after the stale
        tags drain."""
        if params.weight <= 0:
            raise ValueError(f"class {name!r}: weight must be > 0")
        with self._lock:
            st = self._classes.get(name)
            if st is None:
                if not register or self.max_dynamic <= 0:
                    return False
                self._register_dynamic_locked(name, params)
                return True
            st.params = params
            now = self._clock()
            st.r_tag = st.p_tag = st.l_tag = now
            self._cond.notify_all()
            return True

    @staticmethod
    def _idle_reset_locked(st: _ClassState, now: float) -> None:
        """A class going non-empty resets its cadence to "now" (dmclock's
        idle-client tag reset) — tags advance per dequeue otherwise."""
        p = st.params
        if p.reservation:
            st.r_tag = max(st.r_tag, now)
        if p.limit:
            st.l_tag = max(st.l_tag, now)
        st.p_tag = max(st.p_tag, now)

    # -- producer ----------------------------------------------------------
    def enqueue(self, cls: str, item) -> None:
        now = self._clock()
        with self._lock:
            st = self._classes.get(cls)
            if st is None:
                if self.max_dynamic > 0:
                    # a class retired between client_class() and here
                    # (or a controller-side name): the catch-all takes it
                    st = self._classes[DEFAULT_CLASS]
                else:
                    raise KeyError(cls)
            empty = not st.queue
            self._seq += 1
            st.queue.append((self._seq, now, item))
            if empty:
                self._idle_reset_locked(st, now)
            self._cond.notify()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._cond.notify_all()

    def client_op_done(self) -> None:
        """Return a dynamic-class op's execution slot (the executor's
        half of the ``client_slots`` contract) and wake the sleeper so
        gated classes re-enter eligibility."""
        with self._lock:
            if self._slots_busy > 0:
                self._slots_busy -= 1
            self._cond.notify_all()

    # -- consumer ----------------------------------------------------------
    def _pick_locked(self, now: float):
        """(cls, item) of the next eligible op, or (None, wake_at)."""
        best_r = None  # (r_tag, name)
        best_p = None  # (p_tag, name)
        wake = None
        gate_open = (self.client_slots <= 0
                     or self._slots_busy < self.client_slots)
        for name, st in self._classes.items():
            if not st.queue:
                continue
            if st.dynamic and not gate_open:
                # client-op slots exhausted: dynamic classes wait for a
                # client_op_done() wakeup; background/static stay
                # eligible
                continue
            p = st.params
            if p.reservation and st.r_tag <= now:
                if best_r is None or st.r_tag < best_r[0]:
                    best_r = (st.r_tag, name)
                continue  # reservation-phase candidates skip P
            if p.limit and st.l_tag > now:
                wake = st.l_tag if wake is None else min(wake, st.l_tag)
                if p.reservation:
                    # a due reservation beats the ceiling (the R branch
                    # above ignores limit), so the sleeper must wake at
                    # r_tag too — else reservations of limit-gated
                    # classes are honored only at the poll cadence
                    wake = min(wake, st.r_tag)
                continue
            if best_p is None or st.p_tag < best_p[0]:
                best_p = (st.p_tag, name)
            if p.reservation:
                wake = st.r_tag if wake is None else min(wake, st.r_tag)
        name = best_r[1] if best_r is not None else (
            best_p[1] if best_p is not None else None
        )
        if name is None:
            return None, wake
        st = self._classes[name]
        _, enq_ts, item = st.queue.pop(0)
        st.served += 1
        _hist_add(st.wait, max(0.0, now - enq_ts))
        if st.dynamic and self.client_slots > 0:
            # slot taken atomically with the pick (no worker race)
            self._slots_busy += 1
        p = st.params
        if p.reservation:
            st.r_tag = max(now, st.r_tag) + 1.0 / p.reservation
        if p.limit:
            st.l_tag = max(now, st.l_tag) + 1.0 / p.limit
        st.p_tag = max(now, st.p_tag) + 1.0 / p.weight
        return (name, item), None

    def dequeue(self, timeout: float | None = None):
        """Blocking pop -> (class, item) or None on stop/timeout."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._lock:
            while not self._stopped:
                picked, wake = self._pick_locked(self._clock())
                if picked is not None:
                    return picked
                now = self._clock()
                waits = [w - now for w in (wake,) if w is not None]
                if deadline is not None:
                    if now >= deadline:
                        return None
                    waits.append(deadline - now)
                self._cond.wait(timeout=min(waits) if waits else None)
            return None

    def qlen(self) -> int:
        with self._lock:
            return sum(len(st.queue) for st in self._classes.values())

    # -- introspection (dump_op_queue / SchedulerPerf) ----------------------
    def dump(self) -> dict:
        """Per-class snapshot: depth, served, wait histogram, params —
        the ``dump_op_queue`` admin command's payload."""
        with self._lock:
            classes = {}
            for name, st in self._classes.items():
                classes[name] = {
                    "depth": len(st.queue),
                    "served": st.served,
                    "dynamic": st.dynamic,
                    "reservation": st.params.reservation,
                    "weight": st.params.weight,
                    "limit": st.params.limit,
                    "wait": {"count": st.wait["count"],
                             "sum": st.wait["sum"],
                             "buckets": list(st.wait["buckets"])},
                }
            return {
                "classes": classes,
                "dynamic_classes": len(self._lru),
                "max_dynamic": self.max_dynamic,
                "client_slots": self.client_slots,
                "slots_busy": self._slots_busy,
                "retired": self._retired,
                "retired_served": self._retired_served,
                "retired_wait": {
                    "count": self._retired_wait["count"],
                    "sum": self._retired_wait["sum"],
                    "buckets": list(self._retired_wait["buckets"]),
                },
            }


class SchedulerPerf:
    """PerfCounters duck type over one scheduler's per-class stats:
    ``cct.perf.add(SchedulerPerf(sched))`` rides the labeled-rows
    branch of the perf dump -> MMgrReport -> prometheus pipeline
    (``ceph_mclock_depth{ceph_daemon,qclass}`` and friends), bounded by
    max_dynamic here and ``_fold_labeled_rows`` at exposition."""

    def __init__(self, sched: MClockScheduler, name: str = "mclock"):
        self.name = name
        self._sched = sched

    def dump(self) -> dict:
        snap = self._sched.dump()
        rows = []
        for cname, c in sorted(snap["classes"].items()):
            rows.append({
                "labels": {"qclass": cname},
                "depth": c["depth"],
                "served": c["served"],
                "reservation": c["reservation"],
                "weight": c["weight"],
                "limit": c["limit"],
                "wait": c["wait"],
            })
        if snap["retired_served"] or snap["retired"]:
            rows.append({
                "labels": {"qclass": RETIRED_KEY},
                "depth": 0,
                "served": snap["retired_served"],
                "reservation": 0.0, "weight": 0.0, "limit": 0.0,
                "wait": snap["retired_wait"],
            })
        return {
            "per_class": {"__labeled__": True, "rows": rows},
            "queue_len": sum(
                c["depth"] for c in snap["classes"].values()),
            "dynamic_classes": snap["dynamic_classes"],
            "retired": snap["retired"],
        }

    def schema(self) -> dict:
        return {
            "per_class": {
                "type": "labeled",
                "description": "per-QoS-class mClock scheduler rows "
                               "(bounded dynamic classes + _retired_ "
                               "fold; docs/qos.md)"},
            "depth": {"type": "gauge",
                      "description": "ops queued in this QoS class"},
            "served": {"type": "u64",
                       "description": "ops dequeued from this QoS class"},
            "reservation": {"type": "gauge",
                            "description": "class reservation (ops/s; "
                                           "0 = no floor)"},
            "weight": {"type": "gauge",
                       "description": "class proportional-share weight"},
            "limit": {"type": "gauge",
                      "description": "class limit (ops/s; 0 = no "
                                     "ceiling)"},
            "wait": {"type": "histogram",
                     "description": "enqueue -> dequeue wait per class"},
            "queue_len": {"type": "gauge",
                          "description": "total ops queued across "
                                         "classes"},
            "dynamic_classes": {"type": "gauge",
                                "description": "live per-client QoS "
                                               "classes"},
            "retired": {"type": "u64",
                        "description": "dynamic classes LRU-folded into "
                                       "_default_/_retired_"},
        }
