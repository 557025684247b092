"""cephtrace — tracepoints, causal distributed spans, and device
profiling (reference: src/tracing/*.tp LTTng tracepoints,
src/common/tracer.{h,cc} Jaeger spans; SURVEY.md §5.1).

Three layers, all gated on ONE attribute check when disabled:

- **Tracepoints**: ``tracepoint(subsys, event, **fields)`` appends a
  timestamped record to a bounded in-memory ring (the LTTng-userspace
  role); ``span(subsys, name)`` brackets a region and records its
  duration.  Every record carries an ``entity`` label (daemon name) so
  a multi-daemon process (LocalCluster) stays attributable.  Dump via
  ``events()`` / the per-daemon ``dump_tracing`` admin-socket command.

- **Causal spans** (the cephtrace core): a :class:`TraceCtx`
  (trace_id, span_id) is born at ``Objecter.op_submit`` when the
  head-based ``trace_sampling_rate`` coin flip says so, rides wire
  messages as explicit ``trace_id`` / ``parent_span`` FIELDS (named so
  ``send_message``'s framing stamp of ``seq``/``src`` can never shadow
  them — the CL6 ``field-shadow`` trap), and every stage along
  client -> OSD dispatch -> write-batcher admission/queue/flush ->
  encode -> sub-op fan-out -> replica commit -> ack records a
  :class:`Span` into a bounded per-process buffer.  ``assemble_trees``
  rebuilds the causal tree; ``perfetto_export`` emits Chrome-trace /
  Perfetto JSON that loads directly in ui.perfetto.dev.

  **Tail sampling** (cephmeter, ``trace_tail_latency_ms``): an op that
  LOSES the coin flip can still mint a *provisional* context
  (``sampled_ctx(rate, tail=True)``) — its spans buffer aside until
  the op completes, then ``promote``/``discard`` renders the verdict
  (primary: complaint-time/threshold crossing; client: its own e2e;
  promote wins).  A p99 straggler keeps its connected cross-entity
  tree even at ``trace_sampling_rate = 0``
  (docs/observability.md).

- **Device profiling**: ``device_trace(logdir)`` wraps
  ``torch.profiler.profile`` so hot paths on the card write a Chrome
  trace, and ``kernel_annotation(name, trace_ids)`` wraps individual
  kernel launches in a named ``torch.profiler.record_function`` plus an
  NVTX range keyed by trace_id, so the device trace correlates with
  host spans.

Stage taxonomy (shared verbatim by ``TrackedOp.mark_event`` offsets,
the ``stage_*`` latency histograms, and span names — one clock,
``trace_now`` = ``time.time``):

==============  ======================================================
``admission``   write-batcher admission-throttle wait
``queue``       stripe queued -> flush started (coalescing wait)
``encode``      fused device encode (one flush; fan-in span)
``subop``       sub-op fan-out -> last shard ack collected
``commit``      local object-store transaction
==============  ======================================================
"""
from __future__ import annotations

import os
import random
import threading
import time

from .lockdep import make_lock
from contextlib import contextmanager, nullcontext

_MAX_EVENTS = 10_000
_MAX_SPANS = 20_000
#: tail sampling: at most this many traces buffered provisionally
#: (awaiting their op's completion verdict) at once
_MAX_PROVISIONAL = 1024
#: spans one provisional trace may buffer (a runaway op must not eat
#: the process)
_MAX_PROV_SPANS = 256
#: promoted/discarded verdicts remembered (late spans of a decided
#: trace route by these)
_MAX_DECIDED = 8192

#: the stage names above, in pipeline order (bench/tests iterate this)
OP_STAGES = ("admission", "queue", "encode", "subop", "commit")

#: background-plane stage taxonomy (cephheal): recovery and scrub spans,
#: the OSD's recovery_*/scrub_* latency histograms, and TrackedOp marks
#: share these names verbatim, exactly like OP_STAGES on the client path
BG_STAGES = (
    "recovery_peer",      # MPGQuery round: peer versions + object lists
    "recovery_pull",      # authoritative-log catch-up (MPGPull wait)
    "recovery_rebuild",   # one shard chunk recomputed (gather + decode)
    "recovery_push",      # push round to one peer (delta or backfill)
    "scrub_read",         # shard ScrubMap collection
    "scrub_compare",      # cross-shard digest comparison
    "scrub_repair",       # flagged-shard rebuild + re-push
)

#: cephread's read-side stage twins (span names and the
#: ``stage_read_*`` histograms share these, exactly like OP_STAGES on
#: the write path) — kept separate because the read path has no
#: admission/queue phases
READ_STAGES = (
    "read_gather",        # chunk fan-out wall time (batched or per-op)
    "read_decode",        # degraded reconstruct (ranged window or full)
)

#: every (subsys, event) tracepoint name the package may emit, as
#: "subsys.event" — the cephlint CL12 catalogue: an emitting site
#: outside this set is a typo'd event nothing can alert on, an entry
#: with no site is a promise the ring never keeps
KNOWN_TRACEPOINTS = frozenset({
    "ops.kernel_fallback_latched",   # codec latched Pallas→XLA downgrade
    "ops.kernel_fallback_cleared",   # latch cleared (asok or retune)
    "placement.epoch_diff",          # remap forecast on osdmap advance
    "balancer.pass",                 # one balancer pass (scores + moves)
    "balancer.skipped",              # pass refused (degraded cluster)
    "balancer.commit_failed",        # one upmap commit the mon refused
    "qos.retune",                    # controller applied a new plan
    "qos.reject",                    # OSD rejected a malformed directive
    "qos.apply",                     # OSD applied a directive
    "recovery.error",                # one failed recovery pass
    "msgr.send",                     # traced message framed to a peer
    "msgr.recv",                     # traced message accepted from a peer
})


def trace_now() -> float:
    """THE clock every tracing consumer shares: wall time, so
    dump_historic_ops offsets, span boundaries, and cross-daemon
    ordering all agree (monotonic clocks are per-process and would
    skew multi-process traces)."""
    return time.time()


def _new_id() -> str:
    return f"{random.getrandbits(64):016x}"


class TraceCtx:
    """Propagated trace context: which trace, and which span children
    attach to.  ``span_id`` is None only for a freshly minted root."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str | None = None):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"<TraceCtx {self.trace_id}/{self.span_id}>"


class Span:
    __slots__ = ("trace_id", "span_id", "parent", "name", "entity",
                 "t0", "t1", "tags")

    def __init__(self, trace_id: str, parent: str | None, name: str,
                 entity: str, t0: float):
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent = parent
        self.name = name
        self.entity = entity
        self.t0 = t0
        self.t1: float | None = None
        self.tags: dict = {}

    def ctx(self) -> TraceCtx:
        return TraceCtx(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span": self.parent,
            "name": self.name,
            "entity": self.entity,
            "t0": self.t0,
            "t1": self.t1,
            "dur_ms": None if self.t1 is None else (self.t1 - self.t0) * 1e3,
            **({"tags": self.tags} if self.tags else {}),
        }


# thread-local "current op" trace state: the op thread sets it once in
# _handle_client_op and the layers below (write batcher, encode, sub-op
# fan-out) read it without threading ctx through every signature
_tls = threading.local()


def set_op_trace(state: dict | None) -> None:
    _tls.op = state


def op_trace() -> dict | None:
    return getattr(_tls, "op", None)


class Tracer:
    def __init__(self):
        self.enabled = False
        self._events: list[tuple] = []
        self._spans: list[Span] = []
        # tail sampling (cephmeter): traces whose head coin flip said NO
        # buffer here until their op completes; promotion moves them
        # into _spans retroactively, a discard drops them.  All three
        # structures are insertion-ordered so bounds evict oldest-first.
        self._provisional: dict[str, list[Span]] = {}
        self._promoted: dict[str, bool] = {}
        self._discarded: dict[str, bool] = {}
        self._lock = make_lock("tracer::ring")

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    # -- tracepoints (the LTTng layer) ---------------------------------
    def tracepoint(self, subsys: str, event: str, entity: str = "",
                   **fields) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                (trace_now(), entity, subsys, event, fields))
            if len(self._events) > _MAX_EVENTS:
                del self._events[: _MAX_EVENTS // 10]

    @contextmanager
    def span(self, subsys: str, name: str, entity: str = "", **fields):
        if not self.enabled:
            yield
            return
        t0 = trace_now()
        try:
            yield
        finally:
            self.tracepoint(
                subsys, name, entity=entity,
                dur_ms=(trace_now() - t0) * 1e3, **fields
            )

    def events(self, subsys: str | None = None,
               entity: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return [
            {"ts": ts, "entity": ent, "subsys": s, "event": e, **f}
            for ts, ent, s, e, f in evs
            if (subsys is None or s == subsys)
            and (entity is None or ent == entity)
        ]

    # -- causal spans (the cephtrace layer) ----------------------------
    def new_trace(self) -> TraceCtx | None:
        """Mint a root context (the Objecter's head-based sampling
        decision happens BEFORE this call)."""
        if not self.enabled:
            return None
        return TraceCtx(_new_id(), None)

    def begin(self, ctx: TraceCtx | None, name: str, entity: str = "",
              t0: float | None = None, **tags) -> Span | None:
        """Open a child span of ``ctx``; returns None (and every later
        call on None is a no-op) when tracing is off or the op is
        unsampled — the one-attribute-check disabled path."""
        if not self.enabled or ctx is None:
            return None
        sp = Span(ctx.trace_id, ctx.span_id, name, entity,
                  trace_now() if t0 is None else t0)
        if tags:
            sp.tags.update(tags)
        return sp

    def end(self, sp: Span | None, t1: float | None = None, **tags) -> None:
        if sp is None:
            return
        sp.t1 = trace_now() if t1 is None else t1
        if tags:
            sp.tags.update(tags)
        with self._lock:
            buf = self._provisional.get(sp.trace_id)
            if buf is not None:
                # tail-sampling hold: the op's completion verdict
                # (promote/discard) decides this span's fate
                if len(buf) < _MAX_PROV_SPANS:
                    buf.append(sp)
                return
            if sp.trace_id in self._discarded:
                return  # the op completed fast; its late spans drop too
            self._spans.append(sp)
            if len(self._spans) > _MAX_SPANS:
                del self._spans[: _MAX_SPANS // 10]

    # -- tail sampling (retroactive promotion) -------------------------
    def mark_provisional(self, trace_id: str | None) -> None:
        """Register a trace whose head coin flip said no: its spans
        buffer until promote()/discard() renders the verdict.  Bounded —
        the oldest undecided trace is discarded on overflow."""
        if trace_id is None:
            return
        with self._lock:
            if (trace_id in self._provisional
                    or trace_id in self._promoted
                    or trace_id in self._discarded):
                return
            while len(self._provisional) >= _MAX_PROVISIONAL:
                old = next(iter(self._provisional))
                del self._provisional[old]
                self._note_decided_locked(self._discarded, old)
            self._provisional[trace_id] = []

    def is_provisional(self, trace_id: str | None) -> bool:
        if trace_id is None:
            return False
        with self._lock:
            return trace_id in self._provisional

    def _note_decided_locked(self, table: dict, trace_id: str) -> None:
        table[trace_id] = True
        while len(table) > _MAX_DECIDED:
            del table[next(iter(table))]

    def promote(self, trace_id: str | None, reason: str = "") -> bool:
        """Retroactively keep a provisionally buffered trace: its spans
        move into the real buffer and every LATER span of the trace
        records normally.  Idempotent; safe (and a no-op beyond the
        verdict note) on a head-sampled trace.  Returns True when
        buffered spans were actually promoted."""
        if trace_id is None:
            return False
        with self._lock:
            buf = self._provisional.pop(trace_id, None)
            self._discarded.pop(trace_id, None)
            self._note_decided_locked(self._promoted, trace_id)
            if not buf:
                return False
            if reason:
                for sp in buf:
                    sp.tags.setdefault("tail_promoted", reason)
            self._spans.extend(buf)
            if len(self._spans) > _MAX_SPANS:
                del self._spans[: _MAX_SPANS // 10]
            return True

    def discard(self, trace_id: str | None) -> bool:
        """Drop a provisionally buffered trace (the op completed fast).
        A trace ANY participant already promoted stays promoted — the
        primary's complaint-time verdict wins over the client's."""
        if trace_id is None:
            return False
        with self._lock:
            if trace_id in self._promoted:
                return False
            self._provisional.pop(trace_id, None)
            self._note_decided_locked(self._discarded, trace_id)
            return True

    def record(self, ctx: TraceCtx | None, name: str, entity: str = "",
               t0: float | None = None, t1: float | None = None,
               **tags) -> None:
        """One-shot span with explicit boundaries."""
        sp = self.begin(ctx, name, entity, t0=t0, **tags)
        if sp is not None:
            self.end(sp, t1=t1)

    def spans(self, trace_id: str | None = None,
              entity: str | None = None) -> list[dict]:
        with self._lock:
            sps = list(self._spans)
        return [
            s.to_dict() for s in sps
            if (trace_id is None or s.trace_id == trace_id)
            and (entity is None or s.entity == entity)
        ]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._spans.clear()
            self._provisional.clear()
            self._promoted.clear()
            self._discarded.clear()


TRACER = Tracer()
tracepoint = TRACER.tracepoint
span = TRACER.span


def sampled_ctx(rate: float, tail: bool = False) -> TraceCtx | None:
    """Head-based sampling: one coin flip per logical op, at the
    Objecter (reference: Jaeger's probabilistic sampler).  rate >= 1
    always samples; rate <= 0 never does.

    ``tail=True`` (cephmeter tail sampling, armed by
    ``trace_tail_latency_ms``) turns a losing coin flip into a
    PROVISIONAL context instead of None: every stage still records, but
    the spans buffer aside until the op's completion latency renders
    the promote/discard verdict — a p99 straggler keeps its trace even
    at ``trace_sampling_rate=0``."""
    if not TRACER.enabled:
        return None
    if rate >= 1.0 or (rate > 0.0 and random.random() < rate):
        return TRACER.new_trace()
    if not tail:
        return None
    ctx = TraceCtx(_new_id(), None)
    TRACER.mark_provisional(ctx.trace_id)
    return ctx


# -- trace assembly / export ------------------------------------------

def assemble_trees(spans: list[dict]) -> dict[str, list[dict]]:
    """{trace_id: [root trees]}; tree node = {"span": span_dict,
    "children": [nodes]}.  A span whose parent isn't in its trace's
    span set roots its own subtree (e.g. a dropped buffer segment)."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    out: dict[str, list[dict]] = {}
    for tid, sps in by_trace.items():
        nodes = {s["span_id"]: {"span": s, "children": []} for s in sps}
        roots = []
        for s in sps:
            parent = s.get("parent_span")
            if parent is not None and parent in nodes:
                nodes[parent]["children"].append(nodes[s["span_id"]])
            else:
                roots.append(nodes[s["span_id"]])
        out[tid] = roots
    return out


def tree_span_names(node: dict) -> set[str]:
    """All span names reachable from a tree node (connectivity checks)."""
    names = {node["span"]["name"]}
    for child in node["children"]:
        names |= tree_span_names(child)
    return names


def connected_traces(spans: list[dict], root: str = "op_submit",
                     leaf: str = "replica_commit") -> list[str]:
    """trace_ids whose tree reaches `leaf` under a `root` root — the
    ci-gate's "client submit is an ancestor of the replica commit"
    assertion."""
    out = []
    for tid, roots in assemble_trees(spans).items():
        for node in roots:
            if node["span"]["name"] == root and leaf in tree_span_names(node):
                out.append(tid)
                break
    return out


def perfetto_export(spans: list[dict]) -> dict:
    """Chrome-trace/Perfetto JSON: one X (complete) event per span,
    one pid per entity (process_name metadata), one tid per trace so a
    trace's spans nest in one track.  Opens directly in
    ui.perfetto.dev / chrome://tracing."""
    pids: dict[str, int] = {}
    tids: dict[str, int] = {}
    events: list[dict] = []
    for s in spans:
        ent = s.get("entity") or "?"
        if ent not in pids:
            pids[ent] = len(pids) + 1
            events.append({
                "ph": "M", "pid": pids[ent], "name": "process_name",
                "args": {"name": ent},
            })
        tid = tids.setdefault(s["trace_id"], len(tids) + 1)
        if s.get("t1") is None:
            continue  # unfinished span: nothing to draw
        events.append({
            "name": s["name"],
            "cat": "cephtrace",
            "ph": "X",
            "ts": s["t0"] * 1e6,          # microseconds, per the format
            "dur": max(0.0, (s["t1"] - s["t0"]) * 1e6),
            "pid": pids[ent],
            "tid": tid,
            "args": {
                "trace_id": s["trace_id"],
                "span_id": s["span_id"],
                "parent_span": s.get("parent_span"),
                **(s.get("tags") or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_tracing(entity: str | None = None, fmt: str = "spans") -> object:
    """The `dump_tracing` admin-socket surface: this daemon's spans and
    tracepoint events (entity=None dumps the whole process — useful in
    a LocalCluster where every daemon shares the buffer).  fmt:
    "spans" (default), "perfetto" (Chrome-trace JSON of ALL traces this
    entity touched, with the other daemons' halves included so the
    trees stay connected)."""
    spans = TRACER.spans(entity=entity)
    if fmt == "perfetto":
        if entity is not None:
            touched = {s["trace_id"] for s in spans}
            spans = [s for s in TRACER.spans() if s["trace_id"] in touched]
        return perfetto_export(spans)
    return {
        "entity": entity,
        "enabled": TRACER.enabled,
        "num_spans": len(spans),
        "spans": spans,
        "events": TRACER.events(entity=entity),
    }


# -- device profiling --------------------------------------------------

@contextmanager
def device_trace(logdir: str | None = None):
    """torch.profiler trace context (host and, with a card, CUDA
    activity), written as a Chrome trace into `logdir`; logdir defaults
    to $CEPH_TPU_PROFILE.  A no-op when neither is set, so call sites can
    wrap hot regions unconditionally."""
    logdir = logdir or os.environ.get("CEPH_TPU_PROFILE")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextmanager
def _annotated(label: str):
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def kernel_annotation(name: str, trace_ids=()):
    """Named torch.profiler range (``record_function``) and NVTX range
    around a kernel launch, keyed by trace_id, so the device trace
    correlates with host spans.  Null when tracing is off — kernel
    dispatch stays annotation-free on the hot path."""
    if not TRACER.enabled:
        return nullcontext()
    ids = list(trace_ids)
    label = f"cephtrace:{name}"
    if ids:
        label += f"#trace={ids[0]}" + (f"+{len(ids) - 1}" if len(ids) > 1
                                       else "")
    return _annotated(label)
