"""Sustained-traffic benchmark: N simulated clients x small EC writes,
batched (write batcher) vs per-op (inline codec), aggregate GiB/s and
p99 latency — the ROADMAP "millions of users" metric.  The port's
counterpart of ceph_tpu/bench/traffic.py: every generator takes
``device`` (``cuda`` unless ``"cpu"`` is asked; without a card it
raises), where the batchers' applies, the codecs and the clusters run.
On the card the per-op path launches K1 once per op, the batched path
once per flush (``ops/bitplane.apply_matrix``).

arXiv:1709.05365 (online EC on large-scale SSD arrays) shows system
throughput under sustained small-write traffic is dominated by the
queueing/batching structure in front of the codec, not the codec
itself; this scenario measures exactly that layer.  Each simulated
client is a closed-loop writer: prepare a 4 KiB stripe, submit to the
encode stage, wait for parity, repeat.  ``batched`` mode drives the
production ``WriteBatcher`` (osd/write_batcher.py) — the identical code
path an OSD primary takes; ``perop`` mode submits through the same
entry with coalescing off (ec_batch_window_ms=0), i.e. today's
one-dispatch-per-stripe path.

cephtrace integration (docs/tracing.md): ``--sampling R`` arms the
tracer and head-samples R of the ops, after which the JSON carries a
per-stage p50/p99 breakdown (admission / queue / encode [/ subop /
commit]) computed from the recorded spans — the p99 number finally
says WHICH stage.  ``--cluster`` runs the same closed-loop writers
against a real LocalCluster EC pool (client -> OSD -> replicas), so
the trace trees span daemons; ``--trace-out FILE`` writes the run's
Perfetto/Chrome-trace JSON (open in ui.perfetto.dev).
``--trace-smoke`` is the CI gate: untraced vs sampling=1.0 cluster
runs, asserting a non-empty CONNECTED trace tree, all five stages in
the breakdown, and <=10% tracing overhead.

Usage (bench/baseline.py runs run_scenario as its traffic column; add
``--device cpu`` to run on the host):

    python -m ceph_tpu_torch.bench.traffic --clients 32 --seconds 3 --json
    python -m ceph_tpu_torch.bench.traffic --clients 2 --seconds 2 --smoke
    python -m ceph_tpu_torch.bench.traffic --cluster --sampling 1.0 \
        --trace-out trace.json --json
    python -m ceph_tpu_torch.bench.traffic --trace-smoke

cephqos additions (docs/qos.md): ``--arrivals poisson --rate R`` makes
each client OPEN-loop (seeded exponential gaps at R ops/s — offered
load independent of service rate, the workload that exposes queueing),
and ``--bully [--qos]`` runs the mixed-population fairness scenario (1
heavy streamer vs N small Poisson writers on a real LocalCluster) that
``qa/qos_smoke.py`` gates controller-on against controller-off.

cephstorm additions (docs/storm_sim.md): every generator takes one
``seed`` (CLI ``--seed``) that derives EVERY random stream in the run
and is recorded in every JSON artifact, so any measured run can be
replayed bit-identically; the ``tenant_*`` functions at the bottom are
the pure multi-tenant workload vocabulary (RGW S3 request mixes,
CephFS metadata storms, RBD snapshot churn; bursty/diurnal arrival
shapes over hot-object populations) the storm planner
(qa/storm/planner.py) draws its client events from.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time

import numpy as np

from ..common.tracer import (
    OP_STAGES,
    TRACER,
    connected_traces,
    perfetto_export,
    sampled_ctx,
    set_op_trace,
    trace_now,
)


#: the one default every traffic artifact records when --seed is absent
DEFAULT_SEED = 1234

#: fixed per-purpose stream ids: two generators never share a stream,
#: and the same (seed, stream, index) always yields the same draws —
#: the replay contract the storm harness's plan_digest depends on
_SEED_STREAMS = {
    "stripes": 0,       # run_traffic's pre-built stripe pool
    "poisson": 1,       # per-client open-loop arrival gaps
    "bully_small": 2,   # per-victim Poisson writers in --bully
    "read_stacks": 3,   # run_read_traffic's survivor-stack pool
    "tenant": 4,        # tenant_next_op draws (storm planner)
}


def derive_rng(seed: int, stream: str, index: int = 0):
    """One independent Generator per (run seed, purpose, actor): numpy
    seeds by entropy-pooling the whole int sequence, so streams never
    collide even when ``seed + i`` arithmetic would."""
    return np.random.default_rng(
        [int(seed), _SEED_STREAMS[stream], int(index)])


def stage_breakdown(spans: list[dict],
                    stages: tuple = OP_STAGES) -> dict:
    """{stage: {p50_ms, p99_ms, n}} over recorded span durations — the
    per-stage half of the bench JSON."""
    by_name: dict[str, list[float]] = {}
    for s in spans:
        if s["name"] in stages and s.get("dur_ms") is not None:
            by_name.setdefault(s["name"], []).append(s["dur_ms"])
    out = {}
    for name, durs in by_name.items():
        durs.sort()
        p50, p99 = _pctiles(durs)
        out[name] = {
            "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3),
            "n": len(durs),
        }
    return out


def _chunk_len(write_size: int, k: int, align: int = 64) -> int:
    """ErasureCode.get_chunk_size's shape: ceil(size/k), 64-aligned."""
    padded = -(-write_size // k)
    return -(-padded // align) * align


def _pctiles(sorted_vals: list[float]) -> tuple[float | None, float | None]:
    """(p50, p99) of an already-sorted latency list (the one percentile
    idiom every traffic stat shares), None/None when empty."""
    n = len(sorted_vals)
    if not n:
        return None, None
    return sorted_vals[n // 2], sorted_vals[min(n - 1, int(n * 0.99))]


def per_client_stats(lats: list[list[float]]) -> tuple[dict, float | None]:
    """({client: {ops, p50_ms, p99_ms}}, max/min fairness ratio) over
    per-client latency lists — the regression surface the future QoS
    controller is gated on (cephmeter): a controller that starves one
    writer shows up as fairness_ratio >> 1 before it shows up anywhere
    else.  A FULLY starved client still appears (ops=0) and forces
    fairness_ratio to None — total starvation must fail a
    `fairness_ratio <= X` gate, never pass it by omission."""
    rows: dict[str, dict] = {}
    for i, lat in enumerate(lats):
        ls = sorted(lat)
        p50, p99 = _pctiles(ls)
        rows[str(i)] = {
            "ops": len(ls),
            "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
            "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        }
    ops = [r["ops"] for r in rows.values()]
    fairness = (round(max(ops) / min(ops), 3)
                if ops and min(ops) > 0 else None)
    return rows, fairness


def run_traffic(
    mode: str,
    n_clients: int = 32,
    seconds: float = 3.0,
    write_size: int = 4096,
    k: int = 8,
    m: int = 4,
    window_ms: float = 2.0,
    max_stripes: int = 64,
    max_bytes: int = 8 << 20,
    qd: int = 4,
    warmup: float = 0.25,
    sampling: float = 0.0,
    arrivals: str = "closed",
    rate: float = 100.0,
    conf_overrides: dict | None = None,
    seed: int = DEFAULT_SEED,
    device=None,
) -> dict:
    """One mode's run; returns ops/GiB-per-s/latency stats.
    sampling > 0 arms cephtrace, head-samples that fraction of ops, and
    adds a per-stage p50/p99 breakdown to the result.

    ``arrivals``: "closed" (the original closed-loop writers — every
    client keeps ``qd`` writes in flight, so offered load tracks
    service rate) or "poisson" (OPEN-loop: each client draws seeded
    exponential inter-arrival gaps at ``rate`` ops/s and submits on
    schedule regardless of completions, up to ``qd`` outstanding —
    offered load is independent of the system, which is the workload
    that exposes queueing; a backlogged client notes its lateness in
    ``sched_lag_ms`` instead of silently slowing down)."""
    from ..common.context import CephContext
    from ..gf.matrix import cauchy_good_coding_matrix
    from ..ops.bitplane import apply_matrix
    from ..osd.write_batcher import WriteBatcher

    assert mode in ("batched", "perop"), mode
    assert arrivals in ("closed", "poisson"), arrivals
    mat = np.ascontiguousarray(cauchy_good_coding_matrix(k, m), np.uint8)
    L = _chunk_len(write_size, k)
    rng = derive_rng(seed, "stripes")
    # a small pool of distinct pre-built stripes per client keeps the
    # generator out of the timed loop while avoiding constant-input
    # caching artifacts
    pool = [rng.integers(0, 256, (k, L), dtype=np.uint8) for _ in range(8)]
    ename = f"client.traffic-{mode}"
    overrides = {
        "ec_batch_window_ms": window_ms if mode == "batched" else 0.0,
        "ec_batch_max_stripes": max_stripes,
        "ec_batch_max_bytes": max_bytes,
        "trace_enabled": sampling > 0.0,
    }
    if conf_overrides:
        overrides.update(conf_overrides)
    cct = CephContext(ename, overrides=overrides)
    if sampling > 0.0:
        TRACER.clear()  # this run's spans only
    batcher = WriteBatcher(cct, entity=ename, device=device)
    batcher.start()
    apply_matrix(mat, pool[0], device).cpu()  # build/warm the kernel

    stop_at = [0.0]
    start_gate = threading.Event()
    lats: list[list[float]] = [[] for _ in range(n_clients)]
    sched_lag: list[float] = [0.0] * n_clients  # poisson backlog, seconds

    def client(i: int) -> None:
        # closed mode: each simulated client keeps `qd` writes in
        # flight (the async window a real Objecter's inflight budget
        # allows), completing oldest-first — submit-to-parity latency
        # per op.  poisson mode: submissions follow a seeded
        # exponential-gap schedule instead of the completion clock.
        from collections import deque

        my = lats[i]
        inflight: deque = deque()
        n = 0
        arr_rng = derive_rng(seed, "poisson", i)
        next_due = None  # poisson schedule, monotonic clock

        def submit(x):
            root = (TRACER.begin(sampled_ctx(sampling), "op_submit",
                                 entity=ename, client=i)
                    if sampling > 0.0 else None)
            set_op_trace({"ctx": root.ctx(), "tracked": None}
                         if root is not None else None)
            t0 = time.perf_counter()
            p = batcher.encode_submit(mat, x)
            set_op_trace(None)
            return t0, p, root

        def finish(t0, p, root):
            batcher.encode_wait(p)
            TRACER.end(root)
            my.append(time.perf_counter() - t0)

        start_gate.wait(timeout=30.0)
        if arrivals == "poisson":
            next_due = time.monotonic()
        while time.monotonic() < stop_at[0]:
            if arrivals == "poisson":
                now = time.monotonic()
                if now < next_due:
                    time.sleep(min(next_due - now, 0.05))
                    continue
                sched_lag[i] = max(sched_lag[i], now - next_due)
                next_due += float(arr_rng.exponential(1.0 / max(rate, 1e-6)))
                if len(inflight) >= qd:
                    finish(*inflight.popleft())  # cap outstanding
                x = pool[(i + n) % len(pool)]
                n += 1
                inflight.append(submit(x))
                continue
            while len(inflight) < qd and time.monotonic() < stop_at[0]:
                x = pool[(i + n) % len(pool)]
                n += 1
                inflight.append(submit(x))
            if not inflight:  # clock crossed stop_at before any submit
                break
            finish(*inflight.popleft())
        while inflight:
            finish(*inflight.popleft())

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True,
                         name=f"traffic-{i}")
        for i in range(n_clients)
    ]
    for t in threads:
        t.start()
    # warm the batching pipeline itself before the measured interval
    stop_at[0] = time.monotonic() + warmup + seconds
    start_gate.set()
    time.sleep(warmup)
    for lat in lats:
        lat.clear()
    t_begin = time.monotonic()
    for t in threads:
        t.join(timeout=seconds + 30.0)
    elapsed = time.monotonic() - t_begin
    batcher.stop()

    all_lats = sorted(x for lat in lats for x in lat)
    n_ops = len(all_lats)
    p50, p99 = _pctiles(all_lats)
    stats = batcher.stats()
    out = {
        "mode": mode,
        "arrivals": arrivals,
        "seed": seed,
        "clients": n_clients,
        "write_size": write_size,
        "seconds": round(elapsed, 3),
        "ops": n_ops,
        "gibps": round(n_ops * write_size / max(elapsed, 1e-9) / 2**30, 4),
        "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
        "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        "flushes": stats["flushes"],
        "stripes_per_flush": round(stats["stripes"] / stats["flushes"], 2)
        if stats["flushes"] else None,
    }
    out["per_client"], out["fairness_ratio"] = per_client_stats(lats)
    if arrivals == "poisson":
        out["target_rate"] = rate
        out["sched_lag_ms"] = round(max(sched_lag) * 1e3, 3)
    if sampling > 0.0:
        spans = TRACER.spans()
        LAST_SPANS[:] = spans
        out["sampling"] = sampling
        out["traces"] = len({s["trace_id"] for s in spans})
        out["stages"] = stage_breakdown(spans)
        TRACER.enable(False)
        TRACER.clear()
    return out


#: spans of the most recent traced run, for --trace-out export
LAST_SPANS: list = []


def run_cluster_traffic(
    n_clients: int = 2,
    seconds: float = 2.0,
    write_size: int = 4096,
    k: int = 2,
    m: int = 1,
    n_osds: int | None = None,
    sampling: float = 0.0,
    conf_overrides: dict | None = None,
    seed: int = DEFAULT_SEED,
    device=None,
) -> dict:
    """Closed-loop writers against a REAL LocalCluster EC pool — the
    full client -> OSD -> replicas -> ack path, so traced runs produce
    cross-daemon trees (op_submit -> osd_op -> admission/queue/encode/
    subop/commit -> replica_commit) and the per-stage breakdown covers
    all five OP_STAGES.  No qd knob: op_submit is synchronous, so each
    writer holds exactly one op in flight."""
    from ..qa.vstart import LocalCluster

    if n_osds is None:
        n_osds = k + m + 1  # room for every shard plus one spare
    TRACER.enable(False)
    TRACER.clear()
    overrides = {"trace_enabled": sampling > 0.0,
                 "trace_sampling_rate": sampling if sampling > 0.0 else 1.0,
                 # extra knobs (e.g. osd_client_io_accounting on/off for
                 # the PERF.md overhead comparison) ride on top
                 **(conf_overrides or {})}
    lats: list[list[float]] = [[] for _ in range(n_clients)]
    payloads = [bytes([i % 251] * write_size) for i in range(16)]
    stop_at = [0.0]
    start_gate = threading.Event()
    # every writer completes one UNTIMED write before the window opens:
    # a fresh cluster's first op can land mid-peering and eat an
    # EAGAIN-retry backoff — cluster warmup, not steady-state traffic,
    # and charging it to whichever side drew it made the trace-smoke
    # overhead comparison bimodal (observed ~1.3 s elapsed swings)
    warm_gate = threading.Barrier(n_clients + 1)

    with LocalCluster(n_mons=1, n_osds=n_osds,
                      conf_overrides=overrides, device=device) as cluster:
        cluster.create_ec_pool("traffic", k=k, m=m, pg_num=8)
        client = cluster.client()
        ios = [client.open_ioctx("traffic") for _ in range(n_clients)]

        def writer(i: int) -> None:
            io = ios[i]
            my = lats[i]
            n = 0
            try:
                io.write_full(f"c{i}-0", payloads[i % 16])  # warm, untimed
            except Exception as e:
                # a transient startup failure must not kill the writer
                # (a dead thread would silently halve the measured
                # client count and skew the trace-smoke comparison);
                # the measured loop retries against a settled cluster
                print(f"# traffic: client {i} warm write failed: {e!r}",
                      file=sys.stderr)
            finally:
                try:
                    warm_gate.wait(timeout=30.0)
                except threading.BrokenBarrierError:
                    pass
            start_gate.wait(timeout=30.0)
            while time.monotonic() < stop_at[0]:
                t0 = time.perf_counter()
                io.write_full(f"c{i}-{n % 16}", payloads[(i + n) % 16])
                my.append(time.perf_counter() - t0)
                n += 1

        threads = [
            threading.Thread(target=writer, args=(i,), daemon=True,
                             name=f"traffic-cluster-{i}")
            for i in range(n_clients)
        ]
        for t in threads:
            t.start()
        try:
            warm_gate.wait(timeout=60.0)
        except threading.BrokenBarrierError:
            pass  # a wedged warm write: measure anyway, bounded below
        stop_at[0] = time.monotonic() + seconds
        t_begin = time.monotonic()
        w_begin = trace_now()  # span clock, for the warm-trace filter
        start_gate.set()
        for t in threads:
            t.join(timeout=seconds + 60.0)
        elapsed = time.monotonic() - t_begin
        spans = TRACER.spans()
    if spans:
        # drop the warm writes' traces wholesale (every span of a trace
        # rooted before the gate): their peering-backoff outliers must
        # not feed the stage p50/p99 breakdown or the trace counts any
        # more than the aggregate window they are already excluded from
        root_t0: dict[str, float] = {}
        for s in spans:
            t = s["trace_id"]
            if t not in root_t0 or s["t0"] < root_t0[t]:
                root_t0[t] = s["t0"]
        keep = {t for t, v in root_t0.items() if v >= w_begin}
        spans = [s for s in spans if s["trace_id"] in keep]
    LAST_SPANS[:] = spans
    all_lats = sorted(x for lat in lats for x in lat)
    n_ops = len(all_lats)
    p50, p99 = _pctiles(all_lats)
    out = {
        "mode": "cluster",
        "seed": seed,
        "clients": n_clients,
        "write_size": write_size,
        "rs": f"{k}+{m}",
        "seconds": round(elapsed, 3),
        "ops": n_ops,
        "ops_per_s": round(n_ops / max(elapsed, 1e-9), 1),
        "gibps": round(n_ops * write_size / max(elapsed, 1e-9) / 2**30, 5),
        "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
        "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        "sampling": sampling,
    }
    out["per_client"], out["fairness_ratio"] = per_client_stats(lats)
    if sampling > 0.0:
        out["traces"] = len({s["trace_id"] for s in spans})
        out["connected_traces"] = len(connected_traces(spans))
        out["stages"] = stage_breakdown(spans)
        TRACER.enable(False)
        TRACER.clear()
    return out


def run_bully_traffic(
    n_small: int = 3,
    seconds: float = 4.0,
    bully_streams: int = 6,
    bully_size: int = 1 << 16,
    small_size: int = 4096,
    small_rate: float = 10.0,
    k: int = 2,
    m: int = 1,
    n_osds: int | None = None,
    qos: bool = False,
    settle: float = 0.0,
    conf_overrides: dict | None = None,
    seed: int = DEFAULT_SEED,
    device=None,
) -> dict:
    """The mixed-population fairness scenario (ROADMAP closed-loop QoS;
    docs/qos.md): ONE heavy streamer (``client.bully`` — bully_streams
    closed-loop threads of bully_size writes, offered load limited only
    by service rate) against N small writers (``client.small<i>`` —
    open-loop Poisson arrivals at small_rate ops/s of small_size
    writes, the workload a million light tenants offer).  Runs on a
    REAL LocalCluster (mgr hosted) so the cephqos machinery under test
    is the production path: per-client mClock classes, the batcher
    admission share, and — with ``qos=True`` — the live controller
    retuning both from its own telemetry.

    The headline numbers: pooled victim p50/p99 (the gate that carries
    the "controller improves fairness" claim — victims' tails stop
    paying for the bully), ``victim_satisfaction`` (worst per-victim
    achieved/offered ratio — the STARVATION floor: a wedged victim
    scores << 0.5 while a served one sits near 1.0 modulo Poisson
    arrival noise, so it gates as an absolute floor, never as an
    off-vs-on delta), the raw cephmeter ``fairness_ratio`` (max/min
    ops across every client — kept for observability, but NOT a gate
    here: the bully is closed-loop, so making the cluster FASTER grows
    its op count against the rate-capped victims and pushes max/min the
    wrong way), ``bully_dominance`` (bully ops over mean victim ops),
    and aggregate GiB/s (fairness must not be bought with throughput —
    the gate's 10% budget)."""
    from ..qa.vstart import LocalCluster

    if n_osds is None:
        n_osds = k + m + 1
    overrides = {
        "mgr_report_interval": 0.2,
        "mgr_digest_interval": 0.5,
        # controller cadence fast enough to converge inside the run
        "mgr_qos_interval": 0.3,
        "mgr_qos_active": qos,
        "osd_mclock_client_classes": qos,
        # the measured sweet spot (docs/qos.md): 3 execution slots make
        # the tags bite without serializing the bully's streams
        "osd_mclock_client_slots": 3,
        # off = pre-cephqos admission (one FIFO, no per-client share)
        "ec_batch_client_max_share": 0.25 if qos else 1.0,
        **(conf_overrides or {}),
    }
    lats: list[list[float]] = [[] for _ in range(n_small + 1)]  # [0]=bully
    stop_at = [0.0]
    start_gate = threading.Event()
    warm_gate = threading.Barrier(n_small + bully_streams + 1)

    with LocalCluster(n_mons=1, n_osds=n_osds, with_mgr=True,
                      conf_overrides=overrides, device=device) as cluster:
        cluster.create_ec_pool("bully", k=k, m=m, pg_num=8)
        bully_payload = b"B" * bully_size
        small_payloads = [bytes([i % 251] * small_size) for i in range(8)]
        bully_io = cluster.client("client.bully").open_ioctx("bully")
        small_ios = [cluster.client(f"client.small{i}").open_ioctx("bully")
                     for i in range(n_small)]

        def bully(stream: int) -> None:
            my = lats[0]
            n = 0
            try:
                bully_io.write_full(f"b{stream}-w", bully_payload)
            except Exception as e:
                print(f"# bully warm write failed: {e!r}", file=sys.stderr)
            finally:
                try:
                    warm_gate.wait(timeout=60.0)
                except threading.BrokenBarrierError:
                    pass
            start_gate.wait(timeout=60.0)
            while time.monotonic() < stop_at[0]:
                t0 = time.perf_counter()
                try:
                    bully_io.write_full(f"b{stream}-{n % 8}", bully_payload)
                except Exception as e:
                    print(f"# bully write failed: {e!r}", file=sys.stderr)
                    return
                my.append(time.perf_counter() - t0)
                n += 1

        def small(i: int) -> None:
            io = small_ios[i]
            my = lats[i + 1]
            rng = derive_rng(seed, "bully_small", i)
            n = 0
            try:
                io.write_full(f"s{i}-w", small_payloads[0])
            except Exception as e:
                print(f"# small {i} warm write failed: {e!r}",
                      file=sys.stderr)
            finally:
                try:
                    warm_gate.wait(timeout=60.0)
                except threading.BrokenBarrierError:
                    pass
            start_gate.wait(timeout=60.0)
            # open-loop Poisson: submit on the arrival schedule with
            # catch-up (a backlogged victim's waits show up as latency,
            # not as silently reduced offered load)
            next_due = time.monotonic()
            while time.monotonic() < stop_at[0]:
                now = time.monotonic()
                if now < next_due:
                    time.sleep(min(next_due - now, 0.02))
                    continue
                next_due += float(
                    rng.exponential(1.0 / max(small_rate, 1e-6)))
                t0 = time.perf_counter()
                try:
                    io.write_full(f"s{i}-{n % 8}", small_payloads[n % 8])
                except Exception as e:
                    print(f"# small {i} write failed: {e!r}",
                          file=sys.stderr)
                    return
                my.append(time.perf_counter() - t0)
                n += 1

        threads = [threading.Thread(target=bully, args=(s,), daemon=True,
                                    name=f"bully-{s}")
                   for s in range(bully_streams)]
        threads += [threading.Thread(target=small, args=(i,), daemon=True,
                                     name=f"small-{i}")
                    for i in range(n_small)]
        for t in threads:
            t.start()
        try:
            warm_gate.wait(timeout=120.0)
        except threading.BrokenBarrierError:
            pass
        # settle: traffic flows UNMEASURED while the controller observes
        # its first report deltas and pushes (qos runs need ~2 report
        # intervals + a controller tick before classes/window land)
        stop_at[0] = time.monotonic() + settle + seconds
        start_gate.set()
        if settle > 0:
            time.sleep(settle)
        for lat in lats:
            lat.clear()
        t_begin = time.monotonic()
        for t in threads:
            t.join(timeout=settle + seconds + 120.0)
        elapsed = max(time.monotonic() - t_begin, 1e-9)
        qos_status = None
        sched_dump = None
        if cluster.mgr is not None:
            try:
                qos_status = cluster.mgr.module("qos").status()
            except KeyError:
                qos_status = None  # qos module not hosted this run
        if cluster.osds:
            sched_dump = next(iter(
                cluster.osds.values())).scheduler.dump()

    bully_ops = len(lats[0])
    small_lats = sorted(x for lat in lats[1:] for x in lat)
    small_ops = len(small_lats)
    # worst-victim satisfaction: each victim offers small_rate ops/s for
    # the whole measured window; the one the scheduler starves hardest
    # defines fairness (a fully served population scores ~1.0)
    offered_each = small_rate * elapsed
    victim_satisfaction = (round(
        min(len(lat) for lat in lats[1:]) / offered_each, 3)
        if lats[1:] and offered_each > 0 else None)
    vp50, vp99 = _pctiles(small_lats)
    bl = sorted(lats[0])
    bp50, bp99 = _pctiles(bl)
    per_client, fairness = per_client_stats(lats)
    agg_bytes = bully_ops * bully_size + small_ops * small_size
    out = {
        "mode": "bully",
        "seed": seed,
        "qos": qos,
        "seconds": round(elapsed, 3),
        "bully_streams": bully_streams,
        "bully_size": bully_size,
        "n_small": n_small,
        "small_rate": small_rate,
        "aggregate_gibps": round(agg_bytes / elapsed / 2**30, 5),
        "bully_ops": bully_ops,
        "bully_p50_ms": round(bp50 * 1e3, 3) if bp50 is not None else None,
        "bully_p99_ms": round(bp99 * 1e3, 3) if bp99 is not None else None,
        "victim_ops": small_ops,
        "victim_offered": round(n_small * small_rate * elapsed, 1),
        "victim_p50_ms": round(vp50 * 1e3, 3) if vp50 is not None else None,
        "victim_p99_ms": round(vp99 * 1e3, 3) if vp99 is not None else None,
        "victim_satisfaction": victim_satisfaction,
        "bully_dominance": (round(bully_ops / (small_ops / n_small), 3)
                            if small_ops else None),
        "fairness_ratio": fairness,
        "per_client": per_client,
        "qos_status": qos_status,
        "op_queue": sched_dump,
    }
    return out


def trace_smoke(n_clients: int = 2, seconds: float = 2.0,
                trace_out: str | None = None,
                seed: int = DEFAULT_SEED, device=None) -> tuple[dict, int]:
    """The ci_gate tracing smoke: an untraced cluster run, then a
    sampling=1.0 run.  Fails (rc 1) when the traced run produced no
    connected trace tree, the per-stage breakdown misses one of the
    five OP_STAGES, or tracing costs more than 10% of the untraced
    run's throughput."""
    # throwaway warmup: the first cluster run pays the process-wide
    # kernel build, which would otherwise be charged to the untraced
    # side and mask (or invert) the real tracing overhead
    run_cluster_traffic(n_clients, 0.5, sampling=0.0, seed=seed,
                        device=device)
    untraced = run_cluster_traffic(n_clients, seconds, sampling=0.0,
                                   seed=seed, device=device)
    traced = run_cluster_traffic(n_clients, seconds, sampling=1.0,
                                 seed=seed, device=device)
    if trace_out:
        with open(trace_out, "w") as f:
            json.dump(perfetto_export(LAST_SPANS), f)
    overhead = None
    if untraced["ops_per_s"]:
        overhead = round(
            1.0 - traced["ops_per_s"] / untraced["ops_per_s"], 4)
    problems = []
    if not traced.get("connected_traces"):
        problems.append("no connected trace tree (client submit -> "
                        "replica commit)")
    missing = [s for s in OP_STAGES if s not in (traced.get("stages") or {})]
    if missing:
        problems.append(f"stage breakdown missing {missing}")
    if overhead is not None and overhead > 0.10:
        problems.append(f"tracing overhead {overhead:.1%} > 10%")
    out = {
        "seed": seed,
        "untraced": untraced,
        "traced": traced,
        "tracing_overhead": overhead,
        "trace_out": trace_out,
        "problems": problems,
    }
    return out, (1 if problems else 0)


def run_scenario(
    n_clients: int = 32,
    seconds: float = 3.0,
    write_size: int = 4096,
    k: int = 8,
    m: int = 4,
    window_ms: float = 2.0,
    max_stripes: int = 64,
    max_bytes: int = 8 << 20,
    qd: int = 4,
    seed: int = DEFAULT_SEED,
    device=None,
) -> dict:
    """Both modes + the headline ratio, flat keys for bench/baseline.py."""
    perop = run_traffic("perop", n_clients, seconds, write_size, k, m,
                        window_ms, max_stripes, max_bytes, qd, seed=seed,
                        device=device)
    batched = run_traffic("batched", n_clients, seconds, write_size, k, m,
                          window_ms, max_stripes, max_bytes, qd, seed=seed,
                          device=device)
    speedup = (round(batched["gibps"] / perop["gibps"], 2)
               if perop["gibps"] else None)
    return {
        "traffic_seed": seed,
        "traffic_clients": n_clients,
        "traffic_qd": qd,
        "traffic_write_size": write_size,
        "traffic_rs": f"{k}+{m}",
        "traffic_batched_gibps": batched["gibps"],
        "traffic_perop_gibps": perop["gibps"],
        "traffic_batch_speedup": speedup,
        "traffic_batched_p99_ms": batched["p99_ms"],
        "traffic_perop_p99_ms": perop["p99_ms"],
        "traffic_batched_p50_ms": batched["p50_ms"],
        "traffic_perop_p50_ms": perop["p50_ms"],
        "traffic_stripes_per_flush": batched["stripes_per_flush"],
        "traffic_batched_ops": batched["ops"],
        "traffic_perop_ops": perop["ops"],
        "traffic_batched_fairness_ratio": batched["fairness_ratio"],
        "traffic_perop_fairness_ratio": perop["fairness_ratio"],
    }


def run_read_traffic(
    mode: str,
    n_clients: int = 32,
    seconds: float = 3.0,
    read_size: int = 4096,
    k: int = 4,
    m: int = 2,
    window_ms: float = 2.0,
    max_ops: int = 64,
    max_bytes: int = 8 << 20,
    qd: int = 4,
    warmup: float = 0.25,
    lose: int = 1,
    seed: int = DEFAULT_SEED,
    device=None,
) -> dict:
    """The READ-side twin of `run_traffic`: N closed-loop degraded
    readers against the production ``ReadBatcher`` decode seam
    (osd/read_batcher.py) — each op is one stripe's survivor stack
    multiplied through the codec's cached decode matrix, i.e. exactly
    the work a degraded GET costs the primary after its chunk gather.
    ``batched`` coalesces every concurrent op's stack into one pooled
    ``apply_matrix`` launch per flush; ``perop`` runs the same
    submits with coalescing off (osd_read_batch_window_ms=0), today's
    one-launch-per-read path.  The ratio is the read_smoke gate."""
    from ..common.context import CephContext
    from ..ec.registry import ErasureCodePluginRegistry
    from ..ops.bitplane import apply_matrix
    from ..osd.read_batcher import ReadBatcher

    assert mode in ("batched", "perop"), mode
    codec = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "torch", "k": str(k), "m": str(m)}, device=device)
    L = codec.get_chunk_size(read_size)
    rng = derive_rng(seed, "read_stacks")
    rows = tuple(r for r in range(k + m) if r != lose)[:k]
    dm, dm_key = codec.bitplane._decode_entry(rows)
    # a pool of distinct degraded stripes (survivor stacks) per client
    stacks = []
    for _ in range(8):
        x = rng.integers(0, 256, (k, L), dtype=np.uint8)
        parity = codec.encode_chunks(x).cpu().numpy()
        stacks.append(np.ascontiguousarray(
            np.vstack([x, parity])[list(rows)]))
    ename = f"client.readtraffic-{mode}"
    cct = CephContext(ename, overrides={
        "osd_read_batch_window_ms": window_ms if mode == "batched" else 0.0,
        "osd_read_batch_max_ops": max_ops,
        "osd_read_batch_max_bytes": max_bytes,
    })
    batcher = ReadBatcher(cct, io=None, entity=ename, device=device)
    batcher.start()
    apply_matrix(dm, stacks[0], device).cpu()  # build/warm the kernel

    stop_at = [0.0]
    start_gate = threading.Event()
    lats: list[list[float]] = [[] for _ in range(n_clients)]

    def client(i: int) -> None:
        from collections import deque

        my = lats[i]
        inflight: deque = deque()
        n = 0
        start_gate.wait(timeout=30.0)
        while time.monotonic() < stop_at[0]:
            while len(inflight) < qd and time.monotonic() < stop_at[0]:
                x = stacks[(i + n) % len(stacks)]
                n += 1
                inflight.append(
                    (time.perf_counter(),
                     batcher.decode_submit(dm, x, dm_key)))
            if not inflight:
                break
            t0, p = inflight.popleft()
            batcher.decode_wait(p)
            my.append(time.perf_counter() - t0)
        while inflight:
            t0, p = inflight.popleft()
            batcher.decode_wait(p)
            my.append(time.perf_counter() - t0)

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True,
                         name=f"readtraffic-{i}")
        for i in range(n_clients)
    ]
    for t in threads:
        t.start()
    stop_at[0] = time.monotonic() + warmup + seconds
    start_gate.set()
    time.sleep(warmup)
    for lat in lats:
        lat.clear()
    t_begin = time.monotonic()
    for t in threads:
        t.join(timeout=seconds + 30.0)
    elapsed = time.monotonic() - t_begin
    batcher.stop()

    all_lats = sorted(x for lat in lats for x in lat)
    n_ops = len(all_lats)
    p50, p99 = _pctiles(all_lats)
    stats = batcher.stats()
    op_bytes = k * L  # decoded data bytes delivered per read
    out = {
        "mode": mode,
        "seed": seed,
        "clients": n_clients,
        "read_size": read_size,
        "rs": f"{k}+{m}",
        "seconds": round(elapsed, 3),
        "ops": n_ops,
        "gibps": round(n_ops * op_bytes / max(elapsed, 1e-9) / 2**30, 4),
        "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
        "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        "flushes": stats["flushes"],
        "ops_per_flush": round(stats["ops"] / stats["flushes"], 2)
        if stats["flushes"] else None,
        "decode_groups": stats["decode_groups"],
    }
    out["per_client"], out["fairness_ratio"] = per_client_stats(lats)
    return out


def run_read_scenario(
    n_clients: int = 32,
    seconds: float = 3.0,
    read_size: int = 4096,
    k: int = 4,
    m: int = 2,
    window_ms: float = 2.0,
    max_ops: int = 64,
    max_bytes: int = 8 << 20,
    qd: int = 4,
    seed: int = DEFAULT_SEED,
    device=None,
) -> dict:
    """Both read modes + the headline ratio, flat keys (the read-side
    mirror of `run_scenario`; read_smoke's >=3x gate reads these)."""
    perop = run_read_traffic("perop", n_clients, seconds, read_size, k, m,
                             window_ms, max_ops, max_bytes, qd, seed=seed,
                             device=device)
    batched = run_read_traffic("batched", n_clients, seconds, read_size,
                               k, m, window_ms, max_ops, max_bytes, qd,
                               seed=seed, device=device)
    speedup = (round(batched["gibps"] / perop["gibps"], 2)
               if perop["gibps"] else None)
    return {
        "read_seed": seed,
        "read_clients": n_clients,
        "read_qd": qd,
        "read_size": read_size,
        "read_rs": f"{k}+{m}",
        "read_batched_gibps": batched["gibps"],
        "read_perop_gibps": perop["gibps"],
        "read_batch_speedup": speedup,
        "read_batched_p99_ms": batched["p99_ms"],
        "read_perop_p99_ms": perop["p99_ms"],
        "read_batched_p50_ms": batched["p50_ms"],
        "read_perop_p50_ms": perop["p50_ms"],
        "read_ops_per_flush": batched["ops_per_flush"],
        "read_batched_ops": batched["ops"],
        "read_perop_ops": perop["ops"],
    }


def run_cluster_read_traffic(
    n_clients: int = 4,
    seconds: float = 2.0,
    read_size: int = 4096,
    k: int = 2,
    m: int = 1,
    n_osds: int | None = None,
    scenario: str = "get",
    degraded: bool = False,
    mixed: bool = False,
    working_set: int = 8,
    conf_overrides: dict | None = None,
    seed: int = DEFAULT_SEED,
    device=None,
) -> dict:
    """Closed-loop READERS against a real LocalCluster EC pool — the
    full client -> primary -> gather [-> decode] -> reply path.

    ``scenario``: "get" (GET-heavy: every client hammers one shared hot
    working set — the repeat-read workload the hot-object cache and the
    batcher's fan-out coalescing serve) or "boot" (boot storm: each
    client cold-sweeps its OWN object set in order, the RBD
    many-images-at-once pattern — almost no re-reads, so it measures
    pure gather coalescing).  ``mixed`` interleaves one write_full per
    four ops (cache-invalidation pressure: the cache must never serve
    the pre-write bytes).  ``degraded`` kills one OSD after the preload
    (n_osds defaults to k+m so EVERY read must decode) — the p99 here
    is the read_smoke degraded bar.  Every read is verified against the
    expected payload; ``mismatches`` must stay 0."""
    from ..qa.vstart import LocalCluster

    assert scenario in ("get", "boot"), scenario
    if n_osds is None:
        n_osds = k + m if degraded else k + m + 1
    overrides = {"osd_subop_reply_timeout": 1.5,
                 **(conf_overrides or {})}
    lats: list[list[float]] = [[] for _ in range(n_clients)]
    mismatches = [0] * n_clients
    write_ops = [0] * n_clients
    stop_at = [0.0]
    start_gate = threading.Event()
    warm_gate = threading.Barrier(n_clients + 1)

    with LocalCluster(n_mons=1, n_osds=n_osds,
                      conf_overrides=overrides, device=device) as cluster:
        cluster.create_ec_pool("readtraffic", k=k, m=m, pg_num=8)
        client = cluster.client()
        ios = [client.open_ioctx("readtraffic") for _ in range(n_clients)]
        payloads: dict[str, bytes] = {}
        if scenario == "get":
            oids = [f"hot-{j}" for j in range(working_set)]
            for j, oid in enumerate(oids):
                payloads[oid] = bytes([j % 251]) * read_size
                ios[0].write_full(oid, payloads[oid])
            per_client_oids = [oids] * n_clients
        else:
            per_client_oids = []
            for i in range(n_clients):
                mine = [f"img{i}-{j}" for j in range(working_set)]
                for j, oid in enumerate(mine):
                    payloads[oid] = bytes([(i * 17 + j) % 251]) * read_size
                    ios[i].write_full(oid, payloads[oid])
                per_client_oids.append(mine)
        if degraded:
            # drop one OSD and push the map change: with n_osds == k+m
            # there is no spare to backfill onto, so every PG keeps a
            # missing shard and every read takes the decode path (the
            # primaries the victim held move to survivors)
            victim = sorted(cluster.osds)[-1]
            cluster.kill_osd(victim)
            cluster.mark_osd_down_out(victim)

        def reader(i: int) -> None:
            io = ios[i]
            mine = per_client_oids[i]
            my = lats[i]
            n = 0
            try:
                io.read(mine[i % len(mine)])  # warm, untimed
            except Exception as e:
                print(f"# read traffic: client {i} warm read failed: "
                      f"{e!r}", file=sys.stderr)
            finally:
                try:
                    warm_gate.wait(timeout=30.0)
                except threading.BrokenBarrierError:
                    pass
            start_gate.wait(timeout=30.0)
            while time.monotonic() < stop_at[0]:
                oid = mine[(i + n) % len(mine)]
                n += 1
                if mixed and n % 4 == 0:
                    io.write_full(oid, payloads[oid])
                    write_ops[i] += 1
                    continue
                t0 = time.perf_counter()
                got = io.read(oid)
                my.append(time.perf_counter() - t0)
                if got != payloads[oid]:
                    mismatches[i] += 1

        threads = [
            threading.Thread(target=reader, args=(i,), daemon=True,
                             name=f"readtraffic-cluster-{i}")
            for i in range(n_clients)
        ]
        for t in threads:
            t.start()
        try:
            warm_gate.wait(timeout=60.0)
        except threading.BrokenBarrierError:
            pass
        stop_at[0] = time.monotonic() + seconds
        t_begin = time.monotonic()
        start_gate.set()
        for t in threads:
            t.join(timeout=seconds + 60.0)
        elapsed = time.monotonic() - t_begin
        rb = {"flushes": 0, "ops": 0, "inline": 0, "fanouts": 0}
        rc_hits = rc_misses = rc_inserts = 0
        for o in cluster.osds.values():
            s = o.read_batcher.stats()
            for key in rb:
                rb[key] += s[key]
            cs = o.read_cache.stats()
            rc_hits += cs["hits"]
            rc_misses += cs["misses"]
            rc_inserts += cs["inserts"]

    all_lats = sorted(x for lat in lats for x in lat)
    n_ops = len(all_lats)
    p50, p99 = _pctiles(all_lats)
    out = {
        "mode": "cluster-read",
        "seed": seed,
        "scenario": scenario,
        "degraded": degraded,
        "mixed": mixed,
        "clients": n_clients,
        "read_size": read_size,
        "rs": f"{k}+{m}",
        "seconds": round(elapsed, 3),
        "ops": n_ops,
        "ops_per_s": round(n_ops / max(elapsed, 1e-9), 1),
        "gibps": round(n_ops * read_size / max(elapsed, 1e-9) / 2**30, 5),
        "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
        "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        "mismatches": sum(mismatches),
        "write_ops": sum(write_ops),
        "read_batcher": rb,
        "read_cache": {"hits": rc_hits, "misses": rc_misses,
                       "inserts": rc_inserts},
    }
    out["per_client"], out["fairness_ratio"] = per_client_stats(lats)
    return out


# --- multi-tenant workload vocabulary (cephstorm) ----------------------
#
# Pure, seeded building blocks the storm planner (qa/storm/planner.py)
# composes into thousand-OSD client traffic.  Three tenant kinds model
# the three Ceph front doors: "s3" (RGW request mixes — GET-heavy over
# bucket/key namespaces, diurnal offered load), "fs" (CephFS metadata
# storms — tiny hot writes against a shallow directory tree, bursty),
# "rbd" (block images under snapshot churn — half-and-half rewrites of
# a fixed block population, wave-shaped load).  Everything here is a
# function of (kind, seed-derived rng, position-in-run): no clocks, no
# globals, so identical seeds yield identical op streams.

TENANT_KINDS = ("s3", "fs", "rbd")

#: op mix per tenant kind: relative write/read weights + payload size.
TENANT_MIX = {
    "s3": {"write": 4, "read": 6, "size": 8192},
    "fs": {"write": 7, "read": 3, "size": 512},
    "rbd": {"write": 5, "read": 5, "size": 4096},
}


def tenant_objects(kind: str, tenant: str, n_objects: int) -> list[str]:
    """The tenant's deterministic object-name population, styled after
    its real namespace (S3 bucket/keys, FS paths, RBD image blocks)."""
    if kind == "s3":
        return [f"{tenant}/bkt{j % 8}/obj{j:05d}" for j in range(n_objects)]
    if kind == "fs":
        return [f"{tenant}/dir{j % 16}/f{j:04d}.dat"
                for j in range(n_objects)]
    if kind == "rbd":
        return [f"{tenant}/img{j % 4}.block{j:06d}"
                for j in range(n_objects)]
    raise ValueError(f"unknown tenant kind {kind!r}")


def arrival_intensity(kind: str, t_frac: float) -> float:
    """Relative offered-load multiplier at position ``t_frac`` in [0,1)
    of the run: a diurnal sine for s3, 1-in-4 duty-cycle bursts for fs
    metadata storms, and alternating snapshot-churn waves for rbd.
    Mean is ~O(1) for every kind so mixes stay comparable."""
    t = t_frac % 1.0
    if kind == "s3":
        return 0.5 + math.sin(math.pi * t) ** 2  # one day-night cycle
    if kind == "fs":
        return 2.5 if (t * 8.0) % 1.0 < 0.25 else 0.5  # 8 bursts
    if kind == "rbd":
        return 1.5 if (t * 4.0) % 1.0 < 0.5 else 0.5  # 4 snapshot waves
    raise ValueError(f"unknown tenant kind {kind!r}")


def tenant_next_op(kind: str, rng, objects: list[str],
                   t_frac: float = 0.0,
                   hot_frac: float = 0.125) -> tuple[str, str, int] | None:
    """Draw one client op for a tenant: ``(op, oid, size)`` with op in
    {"write", "read"}, or None when the tenant's bursty/diurnal shape
    thins this slot out (the planner simply skips the event).  Object
    popularity is hot-skewed: ~70% of draws land on the leading
    ``hot_frac`` of the population (the hot-object pattern the read
    cache and the QoS classes must survive), the rest uniform."""
    peak = 2.5  # max of every arrival_intensity shape
    if rng.random() * peak >= arrival_intensity(kind, t_frac):
        return None
    mix = TENANT_MIX[kind]
    w, r = mix["write"], mix["read"]
    op = "write" if rng.random() * (w + r) < w else "read"
    n_hot = max(1, int(len(objects) * hot_frac))
    if rng.random() < 0.7:
        oid = objects[int(rng.integers(n_hot))]
    else:
        oid = objects[int(rng.integers(len(objects)))]
    return op, oid, mix["size"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sustained small-write traffic: batched vs per-op "
                    "encode (aggregate GiB/s + p99 latency)")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--write-size", type=int, default=4096)
    ap.add_argument("-k", type=int, default=None,
                    help="data chunks (default 8; 2 in --cluster mode)")
    ap.add_argument("-m", type=int, default=None,
                    help="parity chunks (default 4; 1 in --cluster mode)")
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--max-stripes", type=int, default=64)
    ap.add_argument("--max-bytes", type=int, default=8 << 20)
    ap.add_argument("--qd", type=int, default=4,
                    help="per-client async window (writes in flight)")
    ap.add_argument("--arrivals", choices=("closed", "poisson"),
                    default="closed",
                    help="closed-loop writers (default) or open-loop "
                    "Poisson arrivals at --rate ops/s per client")
    ap.add_argument("--rate", type=float, default=None,
                    help="per-client arrival rate, ops/s (default 100 "
                    "for --arrivals poisson against the bare batcher; "
                    "10 for --bully's small writers — a real "
                    "LocalCluster serves ~2 orders of magnitude less "
                    "than the in-process batcher, and an open-loop "
                    "rate past its capacity measures only the backlog)")
    ap.add_argument("--bully", action="store_true",
                    help="mixed-population fairness scenario on a real "
                    "LocalCluster: 1 heavy streamer vs N small Poisson "
                    "writers (--clients = small-writer count); "
                    "--qos arms the closed-loop controller")
    ap.add_argument("--qos", action="store_true",
                    help="with --bully: per-client mClock classes + "
                    "batcher share + live QoS controller")
    ap.add_argument("--reads", action="store_true",
                    help="READ-side traffic: batched vs per-op degraded "
                    "decode through the ReadBatcher (with --cluster: "
                    "real GET traffic against a LocalCluster pool)")
    ap.add_argument("--scenario", choices=("get", "boot"), default="get",
                    help="with --reads --cluster: GET-heavy shared "
                    "working set (default) or per-client boot storm")
    ap.add_argument("--degraded", action="store_true",
                    help="with --reads --cluster: kill one OSD after "
                    "preload so every read decodes (no spare to "
                    "backfill onto)")
    ap.add_argument("--mixed", action="store_true",
                    help="with --reads --cluster: interleave one "
                    "write_full per four reads (cache-invalidation "
                    "pressure); implies --cluster")
    ap.add_argument("--sampling", type=float, default=0.0,
                    help="cephtrace head-sampling rate (0 = tracing "
                    "off); >0 adds a per-stage p50/p99 breakdown")
    ap.add_argument("--cluster", action="store_true",
                    help="drive a real LocalCluster EC pool instead of "
                    "the bare write batcher (cross-daemon traces)")
    ap.add_argument("--trace-out", metavar="FILE",
                    help="write the traced run's Perfetto/Chrome-trace "
                    "JSON here (open in ui.perfetto.dev)")
    ap.add_argument("--trace-smoke", action="store_true",
                    help="CI gate: untraced vs sampling=1.0 cluster "
                    "runs; fail on a disconnected trace tree, a "
                    "missing stage, or >10%% tracing overhead")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON dict on stdout")
    ap.add_argument("--device", default="cuda",
                    help="where the batchers, codecs and clusters run "
                    "(default: cuda; without a card it raises; cpu on "
                    "request)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: exit 1 when the batched/per-op "
                    "throughput ratio drops below 1.0")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED,
                    help="derives every random stream in the run "
                    "(stripe pools, Poisson arrivals, bully victims); "
                    "recorded in the JSON so any artifact can be "
                    f"replayed bit-identically (default {DEFAULT_SEED})")
    args = ap.parse_args(argv)
    from ..common.device import resolve_device

    dev = resolve_device(args.device)  # raises without a card
    # cluster-backed modes drive one daemon per shard: default to a
    # geometry a smoke-sized cluster can host (RS(8,4) would mean a
    # 13-daemon in-process cluster — measured pathological)
    if args.k is None:
        args.k = 2 if (args.cluster or args.bully) else 8
    if args.m is None:
        args.m = 1 if (args.cluster or args.bully) else 4
    if args.reads:
        if args.cluster or args.mixed or args.degraded:
            res = run_cluster_read_traffic(
                max(1, args.clients), args.seconds, args.write_size,
                args.k, args.m, scenario=args.scenario,
                degraded=args.degraded, mixed=args.mixed,
                seed=args.seed, device=dev)
        else:
            res = run_read_scenario(args.clients, args.seconds,
                                    args.write_size, qd=args.qd,
                                    window_ms=args.window_ms,
                                    max_bytes=args.max_bytes,
                                    seed=args.seed, device=dev)
        if args.json:
            print(json.dumps(res))
        else:
            for key in sorted(res):
                print(f"{key}: {res[key]}")
        if args.smoke:
            ratio = res.get("read_batch_speedup")
            if ratio is None or ratio < 1.0:
                print(f"# read traffic smoke FAILED: batched/per-op "
                      f"ratio {ratio} < 1.0", file=sys.stderr)
                return 1
            print(f"# read traffic smoke OK: batched/per-op ratio "
                  f"{ratio}", file=sys.stderr)
        return 0
    if args.trace_smoke:
        res, rc = trace_smoke(args.clients, args.seconds,
                              trace_out=args.trace_out, seed=args.seed,
                              device=dev)
        if args.json:
            print(json.dumps(res))
        else:
            for key in sorted(res):
                print(f"{key}: {res[key]}")
        for p in res["problems"]:
            print(f"# trace smoke FAILED: {p}", file=sys.stderr)
        if rc == 0:
            print(f"# trace smoke OK: {res['traced']['connected_traces']} "
                  f"connected traces, overhead {res['tracing_overhead']}",
                  file=sys.stderr)
        return rc
    if args.bully:
        res = run_bully_traffic(n_small=max(1, args.clients),
                                seconds=args.seconds,
                                small_size=args.write_size,
                                small_rate=(args.rate if args.rate
                                            is not None else 10.0),
                                k=args.k, m=args.m, qos=args.qos,
                                settle=1.5 if args.qos else 0.0,
                                seed=args.seed, device=dev)
    elif args.cluster:
        res = run_cluster_traffic(args.clients, args.seconds,
                                  args.write_size, args.k, args.m,
                                  sampling=args.sampling, seed=args.seed,
                                  device=dev)
    elif args.sampling > 0.0:
        # batcher-only traced run: batched mode with stage breakdown
        # (the 1%-sampling overhead measurement drives this directly)
        res = run_traffic("batched", args.clients, args.seconds,
                          args.write_size, args.k, args.m, args.window_ms,
                          args.max_stripes, args.max_bytes, args.qd,
                          sampling=args.sampling, seed=args.seed,
                          device=dev)
    elif args.arrivals == "poisson":
        # open-loop single-mode run: offered load independent of
        # service rate (the queueing-exposing workload)
        res = run_traffic("batched", args.clients, args.seconds,
                          args.write_size, args.k, args.m, args.window_ms,
                          args.max_stripes, args.max_bytes, args.qd,
                          arrivals="poisson",
                          rate=(args.rate if args.rate is not None
                                else 100.0),
                          seed=args.seed, device=dev)
    else:
        res = run_scenario(args.clients, args.seconds, args.write_size,
                           args.k, args.m, args.window_ms, args.max_stripes,
                           args.max_bytes, args.qd, seed=args.seed,
                           device=dev)
    if args.trace_out and LAST_SPANS:
        with open(args.trace_out, "w") as f:
            json.dump(perfetto_export(LAST_SPANS), f)
    if args.json:
        print(json.dumps(res))
    else:
        for key in sorted(res):
            print(f"{key}: {res[key]}")
    if args.smoke:
        ratio = res.get("traffic_batch_speedup")
        if ratio is None or ratio < 1.0:
            print(f"# traffic smoke FAILED: batched/per-op ratio "
                  f"{ratio} < 1.0", file=sys.stderr)
            return 1
        print(f"# traffic smoke OK: batched/per-op ratio {ratio}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
