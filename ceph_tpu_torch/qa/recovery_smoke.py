"""cephheal CI smoke: recovery-plane observability end to end.

The port's counterpart of ceph_tpu/qa/recovery_smoke.py.  It runs on the
device ``--device`` names (``cuda`` by default, ``cpu`` on request): the
cluster's RS(2,1) writes, degraded reads and rebuilds go through K1 there.

    python -m ceph_tpu_torch.qa.recovery_smoke [--device cpu]

Drives the WHOLE surface through the production path, no shortcuts:

1. a LocalCluster (mgr hosted, k+m OSDs so a kill leaves a hole CRUSH
   cannot remap around) with ``trace_sampling_rate=0`` and tail
   sampling armed; two named clients write continuously;
2. one OSD is killed mid-traffic: ``PG_DEGRADED`` must raise with
   per-PG degraded counts, and the progress module must open recovery
   events;
3. the OSD is revived: degraded objects must drain to 0, every event
   must complete at fraction 1.0, and the health checks must clear;
4. the ``ceph_recovery_*{pool,codec}`` labeled series must render on
   the prometheus exporter with a plausible repair ratio
   (bytes_read/bytes_repaired ~ k for the RS pool, within tolerance);
5. the tail-promoted recovery trace must assemble into a connected
   cross-entity tree (recovery root reaching a replica_commit or
   recovery_push on another daemon) — at sampling=0, so promotion did
   the work.

Exit 0 on success; 1 with a `problems` list otherwise.  Prints one JSON
summary on stdout (the gate archives it next to the SARIF artifacts).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

K, M = 2, 1
WSIZE = 4096
POOL = "healsmoke"


from .smoke_util import (assert_no_leaked_threads, scrape as _scrape,
                         wait_for as _wait)


def _series(body: str, metric: str) -> dict[str, float]:
    """{label-block: value} of one metric's samples."""
    out = {}
    for line in body.splitlines():
        if line.startswith(metric + "{"):
            labels, _, val = line.partition("} ")
            out[labels[len(metric) + 1:]] = float(val)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.qa.recovery_smoke",
        description="recovery-plane observability end to end on a "
                    "LocalCluster with the mgr hosted")
    ap.add_argument("--device", default="cuda",
                    help="the cluster's device (default: cuda)")
    args = ap.parse_args(argv)

    from ..common.tracer import TRACER, connected_traces
    from ..qa.vstart import LocalCluster

    problems: list[str] = []
    summary: dict = {}
    TRACER.enable(False)
    TRACER.clear()
    overrides = {
        "mgr_report_interval": 0.2,
        "mgr_digest_interval": 0.2,
        "mgr_progress_interval": 0.2,
        "mgr_recovery_stalled_grace": 1.5,
        "mgr_stale_report_age": 30.0,
        "trace_enabled": True,
        "trace_sampling_rate": 0.0,   # head sampling OFF: tail must win
        "trace_tail_latency_ms": 40.0,
    }
    # Runtime twin of the thread-lifecycle lints: every thread bring-up starts
    # must be gone after teardown.  Held open across the whole cluster
    # lifecycle; closed below so a leak lands in `problems` (the JSON
    # summary still renders) instead of a bare traceback.
    leak_gate = contextlib.ExitStack()
    leak_gate.enter_context(assert_no_leaked_threads())
    with LocalCluster(n_mons=1, n_osds=K + M, with_mgr=True,
                      conf_overrides=overrides, device=args.device) as c:
        c.create_ec_pool(POOL, k=K, m=M, pg_num=4)
        stop = threading.Event()
        wrote: dict[str, int] = {"client.alpha": 0, "client.beta": 0}
        errors: list[str] = []

        def writer(name: str) -> None:
            io = c.client(name).open_ioctx(POOL)
            i = 0
            while not stop.is_set():
                try:
                    io.write_full(f"{name}-{i}", bytes([i % 251 + 1])
                                  * WSIZE)
                    wrote[name] += 1
                except Exception as e:
                    # a write refused mid-kill is the scenario working;
                    # record only so a TOTAL failure is diagnosable
                    errors.append(f"{name}: {e!r}")
                    time.sleep(0.2)
                i += 1
                time.sleep(0.05)

        threads = [threading.Thread(target=writer, args=(n,), daemon=True)
                   for n in wrote]
        for t in threads:
            t.start()
        time.sleep(1.0)  # baseline traffic

        victim = K + M - 1
        c.kill_osd(victim)
        rv, _ = c.mon_command({"prefix": "osd down", "id": victim})
        if rv != 0:
            problems.append(f"osd down refused: {rv}")

        observed = {"degraded": False, "events": False}

        def degraded_visible() -> bool:
            rv2, st = c.mon_command({"prefix": "status"})
            if rv2 != 0:
                return False
            checks = (st.get("health") or {}).get("checks") or {}
            observed["degraded"] |= "PG_DEGRADED" in checks
            observed["events"] |= bool(
                (st.get("progress") or {}).get("events"))
            return observed["degraded"] and observed["events"]

        if not _wait(degraded_visible, timeout=15.0):
            problems.append(
                f"degraded surface incomplete while OSD down: {observed}")
        # the revive must find objects the victim missed, or nothing is
        # recovered (no ceph_recovery_* rows, no recovery trace): keep it
        # down until each writer has landed writes past the re-peering
        # that follows the down map, which can take all of the window
        # above
        landed = dict(wrote)
        if not _wait(lambda: all(wrote[n] >= landed[n] + 2 for n in wrote),
                     timeout=15.0):
            problems.append(f"no degraded writes landed while OSD down: "
                            f"{landed} -> {wrote}")

        c.revive_osd(victim)
        c.mon_command({"prefix": "osd in", "id": victim})

        def healed() -> bool:
            rv2, st = c.mon_command({"prefix": "status"})
            if rv2 != 0:
                return False
            checks = (st.get("health") or {}).get("checks") or {}
            if set(checks) & {"PG_DEGRADED", "RECOVERY_STALLED",
                              "OSD_DOWN"}:
                return False
            # the progress module ticks apart from the digest: its
            # events drain one tick after the pg counts that clear
            # PG_DEGRADED
            if (st.get("progress") or {}).get("events"):
                return False
            pg_info = st.get("pgs_by_state") or {}
            return bool(pg_info)

        healed_ok = _wait(healed, timeout=40.0)
        stop.set()
        for t in threads:
            t.join(timeout=5)
        if not healed_ok:
            problems.append("degraded objects never drained to 0 "
                            "(health checks stuck)")

        # -- progress reached 1.0 -------------------------------------
        rv, prog = c.mon_command({"prefix": "progress"})
        if rv != 0:
            problems.append(f"`progress` failed: {rv} {prog}")
        else:
            done = prog.get("completed") or []
            summary["completed_events"] = len(done)
            if not done:
                problems.append("no completed recovery progress events")
            elif any(e.get("progress") != 1.0 for e in done):
                problems.append(f"completed event below 1.0: {done}")
            if prog.get("events"):
                problems.append(
                    f"events still in flight after heal: {prog['events']}")

        # -- ceph_recovery_* on the exporter with a plausible ratio ----
        url = c.mgr.module("prometheus").url
        read_s: dict = {}
        rep_s: dict = {}

        def recovery_series() -> bool:
            nonlocal read_s, rep_s
            body = _scrape(url)
            read_s = _series(body, "ceph_recovery_bytes_read")
            rep_s = _series(body, "ceph_recovery_bytes_repaired")
            return bool(read_s) and bool(rep_s)

        if not _wait(recovery_series, timeout=10.0):
            problems.append("ceph_recovery_* series never rendered on "
                            "the prometheus exporter")
        else:
            bytes_read = sum(read_s.values())
            bytes_rep = sum(rep_s.values())
            ratio = bytes_read / bytes_rep if bytes_rep else None
            summary["bytes_read"] = bytes_read
            summary["bytes_repaired"] = bytes_rep
            summary["repair_ratio"] = ratio
            # plan-path RS repairs read exactly k chunks per repaired
            # chunk; occasional full-gather fallbacks under live
            # traffic can nudge it up, never below k
            if ratio is None or not (K * 0.9 <= ratio <= (K + M + 1)):
                problems.append(
                    f"repair ratio {ratio} implausible for RS(k={K}) "
                    f"(want ~{K})")

        # -- tail-promoted connected recovery trace --------------------
        spans = TRACER.spans()
        summary["recovery_spans"] = sum(
            1 for s in spans if s["name"] == "recovery")
        conn = (connected_traces(spans, root="recovery",
                                 leaf="replica_commit")
                or connected_traces(spans, root="recovery",
                                    leaf="recovery_push"))
        if not conn:
            problems.append(
                "no connected recovery trace tree at sampling=0 "
                "(tail promotion failed)")
        else:
            ents = {s["entity"] for s in spans
                    if s["trace_id"] == conn[0]}
            summary["trace_entities"] = sorted(ents)
            if len(ents) < 2:
                problems.append(
                    f"recovery trace is not cross-entity: {sorted(ents)}")

        summary["writes"] = dict(wrote)
        summary["write_errors"] = len(errors)
        if not all(wrote.values()):
            problems.append(f"a client never completed a write: {wrote} "
                            f"(first errors: {errors[:3]})")

    try:
        leak_gate.close()
    except AssertionError as e:
        problems.append(str(e))

    TRACER.enable(False)
    TRACER.clear()
    summary["problems"] = problems
    print(json.dumps(summary, indent=2, default=str))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
