"""cephread CI smoke: the coalesced READ plane end to end (the port's
counterpart of ceph_tpu/qa/read_smoke.py).  It runs on the device
``--device`` names (``cuda`` by default, ``cpu`` on request): the read
batcher's decodes and the clusters' codecs run there.

    python -m ceph_tpu_torch.qa.read_smoke [--device cpu]

Five gates, one JSON summary:

1. **batched >= 3x per-op** — the in-process decode-plane scenario
   (``bench/traffic.py run_read_scenario``): 32 closed-loop clients
   issuing 1 KiB degraded reads, batched plane vs one launch per op.
   Small hot-object GETs are the coalescing sweet spot (a per-op
   decode launch is fixed-cost); the bar is a >= 3x aggregate
   throughput ratio.  One retry absorbs host noise.
2. **GET-heavy cluster scenario** — a real ``LocalCluster``, shared hot
   working set, read cache armed: every byte verified, the hot set
   promotes (cache hits move) and reads ride coalesced flushes.
3. **boot storm** — per-client private image sets (zero cross-client
   locality): still zero mismatches, still coalesced.
4. **degraded p99** — one OSD down and out with no spare, every PG
   decoding forever: reads stay correct and p99 stays under a loose
   CI bar (the point is "no timeout-shaped cliff", not a perf number).
5. **ranged degraded decode accounting** — a chunk-interior ranged read
   with a dead data shard dispatches exactly k x window bytes into the
   decode kernel (``read_batch_decode`` telemetry), not k x L.

Exit 0 on success; 1 with a `problems` list otherwise.  Prints one JSON
summary on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

SPEEDUP_BAR = 3.0
DEGRADED_P99_BAR_MS = 500.0


def _decode_bytes_in() -> int:
    from ..common.kernel_telemetry import TELEMETRY

    return TELEMETRY.dump().get("read_batch_decode", {}).get("bytes_in", 0)


def check_speedup(summary: dict, problems: list[str], device) -> None:
    from ..bench.traffic import run_read_scenario

    best: dict = {}
    for attempt in range(2):
        res = run_read_scenario(n_clients=32, seconds=2.0, read_size=1024,
                                device=device)
        if not best or res["read_batch_speedup"] > best["read_batch_speedup"]:
            best = res
        if best["read_batch_speedup"] >= SPEEDUP_BAR:
            break
    summary["speedup"] = {
        k: best[k] for k in
        ("read_batch_speedup", "read_batched_gibps", "read_perop_gibps",
         "read_batched_p99_ms", "read_perop_p99_ms", "read_ops_per_flush",
         "read_clients", "read_size")
    }
    if best["read_batch_speedup"] < SPEEDUP_BAR:
        problems.append(
            f"batched read plane only {best['read_batch_speedup']}x per-op "
            f"(bar: >= {SPEEDUP_BAR}x)")
    if best["read_ops_per_flush"] < 2.0:
        problems.append(
            f"flushes barely coalesce ({best['read_ops_per_flush']} "
            f"ops/flush)")


def check_get_heavy(summary: dict, problems: list[str], device) -> None:
    from ..bench.traffic import run_cluster_read_traffic

    res = run_cluster_read_traffic(
        n_clients=4, seconds=1.5, read_size=4096, scenario="get",
        conf_overrides={"osd_read_cache_bytes": 1 << 20,
                        "osd_read_cache_promote_ops": 4}, device=device)
    summary["get_heavy"] = {k: res[k] for k in
                            ("ops", "ops_per_s", "p99_ms", "mismatches",
                             "read_batcher", "read_cache")}
    if res["mismatches"]:
        problems.append(
            f"GET scenario returned {res['mismatches']} corrupt reads")
    if res["ops"] <= 0:
        problems.append("GET scenario completed no reads")
    if res["read_batcher"]["flushes"] <= 0:
        problems.append("GET scenario never flushed the read batcher")
    if res["read_cache"]["hits"] <= 0:
        problems.append(
            "hot working set never promoted into the read cache "
            f"(hits=0, inserts={res['read_cache']['inserts']})")


def check_boot_storm(summary: dict, problems: list[str], device) -> None:
    from ..bench.traffic import run_cluster_read_traffic

    res = run_cluster_read_traffic(
        n_clients=4, seconds=1.5, read_size=4096, scenario="boot",
        device=device)
    summary["boot_storm"] = {k: res[k] for k in
                             ("ops", "ops_per_s", "p99_ms", "mismatches",
                              "read_batcher")}
    if res["mismatches"]:
        problems.append(
            f"boot storm returned {res['mismatches']} corrupt reads")
    if res["ops"] <= 0:
        problems.append("boot storm completed no reads")
    if res["read_batcher"]["ops"] <= 0:
        problems.append("boot storm never crossed the read batcher")


def check_degraded_p99(summary: dict, problems: list[str], device) -> None:
    from ..bench.traffic import run_cluster_read_traffic

    res = run_cluster_read_traffic(
        n_clients=4, seconds=1.5, read_size=4096, k=2, m=1, degraded=True,
        device=device)
    summary["degraded"] = {k: res[k] for k in
                           ("ops", "ops_per_s", "p50_ms", "p99_ms",
                            "mismatches")}
    if res["mismatches"]:
        problems.append(
            f"degraded reads returned {res['mismatches']} corrupt payloads")
    if res["ops"] <= 0:
        problems.append("degraded scenario completed no reads")
    if res["p99_ms"] > DEGRADED_P99_BAR_MS:
        problems.append(
            f"degraded read p99 {res['p99_ms']}ms over the "
            f"{DEGRADED_P99_BAR_MS}ms bar")


def check_ranged_accounting(summary: dict, problems: list[str],
                            device) -> None:
    import numpy as np

    from ..ec.registry import ErasureCodePluginRegistry
    from ..osd.osdmap import object_ps
    from .vstart import LocalCluster

    conf = {"osd_subop_reply_timeout": 1.5}
    with LocalCluster(n_mons=1, n_osds=6, conf_overrides=conf,
                      device=device) as c:
        c.create_ec_pool("rs", k=4, m=2, pg_num=4)
        io = c.client().open_ioctx("rs")
        rng = np.random.default_rng(17)
        payload = rng.integers(0, 256, 8192, np.uint8).tobytes()
        io.write_full("obj", payload)
        m = c._leader().osdmon.osdmap
        pid = next(i for i, p in m.pools.items() if p.name == "rs")
        ps = object_ps("obj", m.pools[pid].pg_num)
        _up, _upp, acting, primary = m.pg_to_up_acting_osds(pid, ps)
        victim = next(acting[j] for j in range(4)
                      if acting[j] >= 0 and acting[j] != primary)
        c.kill_osd(victim)
        codec = ErasureCodePluginRegistry.instance().factory(
            {"plugin": "torch", "k": "4", "m": "2"}, device=device)
        chunk = codec.get_chunk_size(len(payload))
        off, ln = chunk + 37, 101            # interior of data chunk 1
        b0 = _decode_bytes_in()
        got = io.read("obj", off=off, length=ln)
        ranged_in = _decode_bytes_in() - b0
        summary["ranged"] = {"window_bytes": ln, "chunk_bytes": chunk,
                             "decode_bytes_in": ranged_in,
                             "expected_bytes_in": 4 * ln}
        if got != payload[off:off + ln]:
            problems.append("ranged degraded read returned wrong bytes")
        if ranged_in != 4 * ln:
            problems.append(
                f"ranged degraded decode dispatched {ranged_in} bytes "
                f"into the kernel, expected k x window = {4 * ln}")


def main(argv=None) -> int:
    from ..common.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.qa.read_smoke",
        description="the coalesced read plane end to end")
    ap.add_argument("--device", default="cuda",
                    help="where the batchers and clusters run (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises without a card
    problems: list[str] = []
    summary: dict = {"scenario": "read_smoke"}
    for check in (check_speedup, check_get_heavy, check_boot_storm,
                  check_degraded_p99, check_ranged_accounting):
        try:
            check(summary, problems, device)
        except Exception as exc:  # a crashed stage is a failed gate
            problems.append(f"{check.__name__} crashed: {exc!r}")
    summary["problems"] = problems
    print(json.dumps(summary, indent=2, default=str))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
