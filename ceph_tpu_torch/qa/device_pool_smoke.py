"""cephdma CI smoke: control-vs-pool traffic run (the port's counterpart
of ceph_tpu/qa/device_pool_smoke.py).

    python -m ceph_tpu_torch.qa.device_pool_smoke [--device cpu]

Runs the batcher traffic scenario in turns on the device ``--device``
names (``cuda`` by default), control, pool, pool, control —
``ec_device_pool=false`` (the historical synchronous flush, the
control) then ``true`` (pooled async encode path) — and compares the
kernel-telemetry deltas:

1. **host-copy bytes per fused flush** (the ``ec_batch_flush`` record)
   must drop >= 50% pool-on vs control: the pooled flush performs only
   the host->device stripe commits, while the control pays host pack +
   packed transfer + full parity fetch.  Both runs are counted by the
   same seam of the port's write batcher (``_encode_groups``); the
   pooled flush counts its stripes' commits at their real count.  The
   deferred commit-point fetches stay visible as the ``encode_wait``
   sync-point record — nothing is hidden, the flusher just stops doing
   it.
2. **aggregate throughput must not regress**: pooled GiB/s >= 0.85x
   control (a noise margin; the bar is "does not regress"), each
   mode's GiB/s the mean of its two runs.
3. the flush record flips honest: control flushes are sync points
   (``sync_points`` > 0), pooled flushes are async (their sync moved to
   ``encode_wait``); the pool's own free-list cycle shows hits.

Exit 0 on success; 1 with a `problems` list otherwise.  Prints one JSON
summary on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys


def _flush_stats() -> dict:
    from ..common.kernel_telemetry import TELEMETRY

    d = TELEMETRY.dump()
    out = {}
    for kern in ("ec_batch_flush", "encode_wait"):
        ks = d.get(kern, {})
        out[kern] = {k: ks.get(k, 0) for k in
                     ("calls", "host_copy_bytes", "sync_points",
                      "bytes_in", "bytes_out")}
    return out


def main(argv=None) -> int:
    from ..bench.traffic import run_traffic
    from ..common.device import resolve_device
    from ..ops.device_pool import POOL

    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.qa.device_pool_smoke",
        description="the write batcher's flush with the device pool off "
                    "and on")
    ap.add_argument("--device", default="cuda",
                    help="where the write batcher runs (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises without a card

    problems: list[str] = []
    summary: dict = {"scenario": "device_pool_smoke"}
    # the two modes in turns (control, pool, pool, control), each
    # mode's figures summed over its two runs: a background load that
    # drifts during the smoke weighs on both modes alike
    sums: dict[str, dict] = {}
    for label, pool_on in (("control", False), ("pool", True),
                           ("pool", True), ("control", False)):
        before = _flush_stats()
        pool_before = POOL.stats()
        res = run_traffic(
            "batched", n_clients=4, seconds=2.0, write_size=4096,
            k=8, m=4, qd=4, warmup=0.75,
            conf_overrides={"ec_device_pool": pool_on}, device=device,
        )
        after = _flush_stats()
        pool_after = POOL.stats()
        acc = sums.setdefault(label, {
            "gibps": [], "ops": 0,
            "pool_hits": 0, "pool_releases": 0,
            **{kern: dict.fromkeys(after[kern], 0) for kern in after}})
        acc["gibps"].append(res["gibps"])
        acc["ops"] += res["ops"]
        for kern in after:
            for k in after[kern]:
                acc[kern][k] += after[kern][k] - before[kern][k]
        acc["pool_hits"] += pool_after["hits"] - pool_before["hits"]
        acc["pool_releases"] += pool_after["releases"] - pool_before["releases"]
    runs: dict[str, dict] = {}
    for label, acc in sums.items():
        flush = acc["ec_batch_flush"]
        flushes = max(1, flush["calls"])
        runs[label] = {
            "gibps": sum(acc["gibps"]) / len(acc["gibps"]),
            "gibps_runs": acc["gibps"],
            "ops": acc["ops"],
            "flushes": flush["calls"],
            "stripes_per_flush": round(acc["ops"] / flushes, 2),
            "host_copy_per_flush": flush["host_copy_bytes"] / flushes,
            "flush_sync_points": flush["sync_points"],
            "encode_wait": acc["encode_wait"],
            "pool_hits": acc["pool_hits"],
            "pool_releases": acc["pool_releases"],
        }
        summary[label] = runs[label]

    ctl, pool = runs["control"], runs["pool"]
    if ctl["flushes"] <= 0 or pool["flushes"] <= 0:
        problems.append("a run produced no fused flushes")
    if ctl["host_copy_per_flush"] <= 0:
        problems.append("control run recorded no flush host-copy bytes")
    else:
        ratio = pool["host_copy_per_flush"] / ctl["host_copy_per_flush"]
        summary["host_copy_ratio"] = round(ratio, 4)
        if ratio > 0.5:
            problems.append(
                f"host-copy bytes per flush only dropped to "
                f"{ratio:.0%} of control (bar: <= 50%)")
    if ctl["gibps"] > 0 and pool["gibps"] < 0.85 * ctl["gibps"]:
        problems.append(
            f"pooled throughput regressed: {pool['gibps']} vs control "
            f"{ctl['gibps']} GiB/s (bar: >= 0.85x)")
    if ctl["flush_sync_points"] <= 0:
        problems.append("control flushes recorded no sync points")
    if pool["flush_sync_points"] > 0:
        problems.append(
            f"pooled flushes still sync on the flusher "
            f"({pool['flush_sync_points']} sync points)")
    if pool["encode_wait"]["sync_points"] <= 0:
        problems.append("pooled run recorded no encode_wait commit syncs")
    if pool["pool_releases"] <= 0:
        problems.append(
            "pooled run never returned a parity buffer to the pool")

    summary["problems"] = problems
    print(json.dumps(summary, indent=2, default=str))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
