"""In-flight op tracking (reference: src/common/TrackedOp.{h,cc} ::
TrackedOp, OpTracker; SURVEY.md §5.1).

Every op carries a timestamped event list; the tracker keeps in-flight ops
plus a bounded deque of completed ("historic") ops, and flags slow ops by
age.  This is the reference's practical profiler — `dump_historic_ops` shows
per-stage latency — and the admin socket exposes the same three dumps here.

cephmeter additions:

- **per-stage durations**: ``stage_add`` accumulates named stage wall
  time (fed by ``OSD._op_stage`` and the write batcher on the same
  ``tracer.trace_now`` clock as the event marks), so a slow op's dump
  says WHICH stage dominated, not just when each ended;
- **slow-op history**: an op that completes slower than the complaint
  time is kept in a separate bounded deque served by
  ``dump_historic_slow_ops`` — with its stage attribution and (when
  cephtrace kept or tail-promoted the trace) the assembled
  cross-entity trace tree;
- **sticky slow accounting**: ``slow_op_count`` adds a decaying
  recent-slow count to the in-flight count, so an op that completes
  slow BETWEEN mgr report polls cannot vanish from SLOW_OPS before the
  digest samples it (the fast-finishing-straggler hole).
"""
from __future__ import annotations

import time
from collections import deque
from .lockdep import make_lock
from .tracer import TRACER, assemble_trees, trace_now


class TrackedOp:
    __slots__ = ("tracker", "desc", "initiated_at", "events", "stages",
                 "trace_id", "src", "_lock")

    def __init__(self, tracker: "OpTracker", desc: str,
                 src: str = "client"):
        self.tracker = tracker
        self.desc = desc
        self.initiated_at = trace_now()
        self.events: list[tuple[float, str]] = [(self.initiated_at, "initiated")]
        # stage -> accumulated seconds (cephmeter per-stage attribution)
        self.stages: dict[str, float] = {}
        # cephtrace context id, when the op rode a (sampled or
        # provisionally buffered) trace — dump_historic_slow_ops uses it
        # to attach the assembled tree
        self.trace_id: str | None = None
        # origin plane (cephheal): "client" ops vs background
        # "recovery"/"scrub" work — background ops keep their own
        # bounded history so a recovery tick can never evict client
        # forensics (and vice versa), but slow ones share the slow-op
        # history so dump_historic_slow_ops covers the whole daemon
        self.src = src
        self._lock = make_lock("optracker::op")

    def mark_event(self, name: str, ts: float | None = None) -> None:
        """`ts` lets a caller that also records a cephtrace span stamp
        BOTH with one clock read (tracer.trace_now) — dump_historic_ops
        per-stage offsets and span boundaries then agree exactly
        (the OSD's _op_stage helper is that caller)."""
        with self._lock:
            self.events.append((trace_now() if ts is None else ts, name))

    def stage_add(self, stage: str, seconds: float) -> None:
        """Accumulate one stage's wall time (several batcher waits or
        sub-op rounds may feed the same stage)."""
        with self._lock:
            self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def age(self, now: float | None = None) -> float:
        return (time.time() if now is None else now) - self.initiated_at

    def duration(self) -> float:
        """Initiation to last recorded event (== total for a finished
        op, whose final event is the 'done' mark)."""
        with self._lock:
            return self.events[-1][0] - self.initiated_at

    def dominant_stage(self) -> tuple[str, float] | None:
        with self._lock:
            if not self.stages:
                return None
            name = max(self.stages, key=self.stages.get)
            return name, self.stages[name]

    def _dom_suffix(self) -> str:
        """The shared ', dominant stage X (N ms)' tail of every
        SLOW_OPS detail line ('' when no stage recorded)."""
        dom = self.dominant_stage()
        if dom is None:
            return ""
        return f", dominant stage {dom[0]} ({dom[1] * 1e3:.1f} ms)"

    def _desc_tagged(self) -> str:
        """Background ops carry their plane in the detail line so a
        SLOW_OPS report distinguishes a recovery pull from a client op."""
        return self.desc if self.src == "client" \
            else f"[{self.src}] {self.desc}"

    def slow_summary(self, now: float | None = None) -> str:
        """One SLOW_OPS detail line naming the dominant stage."""
        return (f"{self._desc_tagged()}: {self.age(now):.2f}s"
                f"{self._dom_suffix()}")

    def dump(self) -> dict:
        with self._lock:
            events = list(self.events)
            stages = dict(self.stages)
        t0 = self.initiated_at
        out = {
            "description": self.desc,
            "src": self.src,
            "initiated_at": t0,
            "age": self.age(),
            "duration": events[-1][0] - t0,
            "type_data": {
                "events": [
                    {"time": ts, "event": name, "offset": ts - t0}
                    for ts, name in events
                ]
            },
        }
        if stages:
            out["stages"] = {
                s: round(d * 1e3, 3) for s, d in stages.items()
            }
            out["dominant_stage"] = max(stages, key=stages.get)
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        return out

    def finish(self) -> None:
        self.mark_event("done")
        self.tracker.unregister(self)

    def __enter__(self) -> "TrackedOp":
        return self

    def __exit__(self, *exc) -> bool:
        self.finish()
        return False


class OpTracker:
    def __init__(self, history_size: int = 20, complaint_time: float = 30.0,
                 recent_slow_window: float = 60.0):
        self._inflight: dict[int, TrackedOp] = {}
        self._history: deque[TrackedOp] = deque(maxlen=history_size)
        # background (recovery/scrub) ops, separately bounded: the
        # per-tick recovery pass must not cycle client ops out of
        # dump_historic_ops, and client bursts must not hide a slow
        # backfill from dump_historic_bg_ops (cephheal)
        self._bg_history: deque[TrackedOp] = deque(
            maxlen=max(1, history_size))
        # completed-slow ops, separately bounded: a burst of fast ops
        # must not push a straggler out of forensic reach
        self._slow_history: deque[TrackedOp] = deque(
            maxlen=max(1, history_size))
        # completion wall-clock stamps of recent slow ops — the sticky
        # SLOW_OPS count (decays after recent_slow_window seconds)
        self._recent_slow: deque[float] = deque(maxlen=1024)
        self._lock = make_lock("optracker::tracker")
        self.complaint_time = complaint_time
        self.recent_slow_window = recent_slow_window

    def create(self, desc: str, src: str = "client") -> TrackedOp:
        op = TrackedOp(self, desc, src=src)
        with self._lock:
            self._inflight[id(op)] = op
        return op

    def unregister(self, op: TrackedOp) -> None:
        slow = (self.complaint_time > 0
                and op.duration() > self.complaint_time)
        with self._lock:
            if self._inflight.pop(id(op), None) is not None:
                if op.src == "client":
                    self._history.append(op)
                else:
                    self._bg_history.append(op)
                if slow:
                    self._slow_history.append(op)
                    self._recent_slow.append(time.time())

    def num_inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = list(self._inflight.values())
        return {"num_ops": len(ops), "ops": [op.dump() for op in ops]}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            ops = list(self._history)
        return {"num_ops": len(ops), "ops": [op.dump() for op in ops]}

    def dump_historic_bg_ops(self) -> dict:
        """Completed background (recovery/scrub) ops — the plane
        dump_historic_ops never saw before cephheal."""
        with self._lock:
            ops = list(self._bg_history)
        return {"num_ops": len(ops), "ops": [op.dump() for op in ops]}

    def dump_historic_slow_ops(self, with_traces: bool = True) -> dict:
        """Completed-slow forensics: stage attribution per op plus (when
        cephtrace kept the spans — head-sampled or tail-promoted) the
        assembled cross-entity trace tree (docs/observability.md)."""
        with self._lock:
            ops = list(self._slow_history)
        out = []
        for op in ops:
            d = op.dump()
            if with_traces and op.trace_id is not None:
                spans = TRACER.spans(trace_id=op.trace_id)
                if spans:
                    d["trace"] = {
                        "trace_id": op.trace_id,
                        "num_spans": len(spans),
                        "entities": sorted({s["entity"] for s in spans}),
                        "tree": assemble_trees(spans).get(op.trace_id, []),
                    }
            out.append(d)
        return {"num_ops": len(out),
                "complaint_time": self.complaint_time, "ops": out}

    def slow_ops(self, now: float | None = None) -> list[TrackedOp]:
        """Ops older than the complaint time (reference: the
        'slow requests' health warning path)."""
        now = time.time() if now is None else now
        with self._lock:
            ops = list(self._inflight.values())
        return [op for op in ops if op.age(now) > self.complaint_time]

    def slow_op_count(self, now: float | None = None) -> int:
        """In-flight slow ops PLUS recently-completed slow ops within
        the decay window — the sticky count SLOW_OPS reports, so a
        straggler that finishes between two mgr report polls still
        surfaces (satellite: no vanishing fast-finishing stragglers)."""
        now = time.time() if now is None else now
        with self._lock:
            while (self._recent_slow
                   and now - self._recent_slow[0] > self.recent_slow_window):
                self._recent_slow.popleft()
            recent = len(self._recent_slow)
        return len(self.slow_ops(now)) + recent

    def slow_summaries(self, now: float | None = None,
                       limit: int = 5) -> list[str]:
        """Detail lines for the SLOW_OPS health check: in-flight slow
        ops first, then the freshest completed stragglers."""
        now = time.time() if now is None else now
        lines = [op.slow_summary(now) for op in self.slow_ops(now)]
        with self._lock:
            recent = list(self._slow_history)
        for op in reversed(recent):
            if len(lines) >= limit:
                break
            lines.append(f"{op._desc_tagged()}: completed in "
                         f"{op.duration():.2f}s{op._dom_suffix()}")
        return lines[:limit]
