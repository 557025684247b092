"""cephmeter CI smoke: per-client accounting + slow-op forensics end to
end (the port's counterpart of ceph_tpu/qa/accounting_smoke.py).  The
cluster runs on the device ``--device`` names (``cuda`` by default: its
EC writes through K1; ``cpu`` on request).

    python -m ceph_tpu_torch.qa.accounting_smoke [--device cpu]

Drives the WHOLE surface through the production path, no shortcuts:

1. a 2-client LocalCluster (mgr hosted) with ``trace_sampling_rate=0``
   and tail sampling armed — two named clients write through an EC
   pool;
2. the prometheus exporter must render per-(client,pool) **labeled**
   series for BOTH clients, and the per-client ``bytes_w`` sums must
   equal the aggregate ``osd.op_w_bytes`` within tolerance (attribution
   conserves bytes);
3. the ``perf history`` mon command must answer with per-daemon samples
   from the mgr's metrics-history digest;
4. a failpoint-delayed op (``osd.write_batcher.flush`` = delay) must
   cross the complaint time and surface in ``dump_historic_slow_ops``
   over a real admin socket — with per-stage attribution, a dominant
   stage, and (tail promotion: the head coin flip said NO to every op)
   an assembled trace artifact spanning more than one entity.

Exit 0 on success; 1 with a `problems` list otherwise.  Prints one JSON
summary on stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


from .smoke_util import scrape as _scrape, wait_for as _wait


def _labeled_value(body: str, metric: str, **labels) -> float:
    """Sum of a labeled metric's samples matching every given label."""
    total = 0.0
    for line in body.splitlines():
        if not line.startswith(metric + "{"):
            continue
        if all(f'{k}="{v}"' in line for k, v in labels.items()):
            total += float(line.rsplit(" ", 1)[1])
    return total


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.qa.accounting_smoke",
        description="per-client accounting and slow-op forensics end to end")
    ap.add_argument("--device", default="cuda",
                    help="the cluster's device (default: cuda)")
    args = ap.parse_args(argv)

    import tempfile

    from ..common.device import resolve_device

    device = resolve_device(args.device)  # raises without a card

    from ..common.admin_socket import admin_socket_command
    from ..common.failpoint import registry as fp_registry
    from ..common.tracer import TRACER
    from ..qa.vstart import LocalCluster

    problems: list[str] = []
    summary: dict = {}
    asok_dir = tempfile.mkdtemp(prefix="ceph_tpu_acct_")
    TRACER.enable(False)
    TRACER.clear()
    overrides = {
        "mgr_report_interval": 0.2,
        "mgr_digest_interval": 0.2,
        "mgr_stale_report_age": 30.0,
        "trace_enabled": True,
        "trace_sampling_rate": 0.0,   # head sampling OFF: tail must win
        "trace_tail_latency_ms": 150.0,
        "osd_op_complaint_time": 0.3,
        "osd_slow_op_window": 120.0,
        "admin_socket": os.path.join(asok_dir, "$name.asok"),
    }
    n_writes, wsize = 12, 4096

    with LocalCluster(n_mons=1, n_osds=4, with_mgr=True,
                      conf_overrides=overrides, device=device) as c:
        c.create_ec_pool("acct", k=2, m=1, pg_num=8)
        alpha = c.client("client.alpha").open_ioctx("acct")
        beta = c.client("client.beta").open_ioctx("acct")
        for i in range(n_writes):
            alpha.write_full(f"a{i}", b"a" * wsize)
            beta.write_full(f"b{i}", b"b" * wsize)

        # -- labeled series on the exporter ---------------------------
        url = c.mgr.module("prometheus").url
        # accounting counts len(b64_payload) * 3 // 4 — the same basis
        # as the aggregate op_w_bytes counter it must reconcile with
        expect = n_writes * (((wsize + 2) // 3 * 4) * 3 // 4)

        def labeled_ready() -> bool:
            body = _scrape(url)
            return (_labeled_value(body, "ceph_client_io_ops",
                                   client="client.alpha") >= n_writes
                    and _labeled_value(body, "ceph_client_io_ops",
                                       client="client.beta") >= n_writes)

        if not _wait(labeled_ready, timeout=20.0):
            problems.append("labeled per-client series never reached the "
                            "exporter")
        body = _scrape(url)
        a_bytes = _labeled_value(body, "ceph_client_io_bytes_w",
                                 client="client.alpha")
        b_bytes = _labeled_value(body, "ceph_client_io_bytes_w",
                                 client="client.beta")
        agg = _labeled_value(body, "ceph_osd_op_w_bytes")
        summary["alpha_bytes_w"] = a_bytes
        summary["beta_bytes_w"] = b_bytes
        summary["aggregate_op_w_bytes"] = agg
        if agg <= 0:
            problems.append("aggregate op_w_bytes is zero")
        elif abs((a_bytes + b_bytes) - agg) > 0.05 * agg:
            problems.append(
                f"per-client bytes {a_bytes}+{b_bytes} do not sum to the "
                f"aggregate {agg} within 5%")
        if abs(a_bytes - expect) > 0.05 * max(expect, 1):
            problems.append(f"alpha bytes_w {a_bytes} != expected "
                            f"~{expect}")

        # -- perf history through the mon -----------------------------
        def history_ready() -> bool:
            rv, res = c.mon_command({"prefix": "perf history"})
            return rv == 0 and bool((res or {}).get("daemons"))

        if not _wait(history_ready, timeout=15.0):
            problems.append("`perf history` never answered with daemons")
        else:
            rv, res = c.mon_command(
                {"prefix": "perf history", "name": "osd.op"})
            if rv != 0 or not res.get("daemons"):
                problems.append(f"`perf history osd.op` failed: {rv} {res}")
            else:
                summary["history_daemons"] = sorted(res["daemons"])

        # -- failpoint-delayed op -> dump_historic_slow_ops -----------
        fp_registry().set("osd.write_batcher.flush", "times(1,delay(0.5))")
        try:
            alpha.write_full("slowpoke", b"s" * wsize)
        finally:
            fp_registry().set("osd.write_batcher.flush", "off")

        def find_slow() -> dict | None:
            for i in c.osds:
                asok = os.path.join(asok_dir, f"osd.{i}.asok")
                try:
                    dump = admin_socket_command(
                        asok, "dump_historic_slow_ops")
                except (OSError, ValueError):
                    continue
                for op in dump.get("ops", []):
                    if "slowpoke" in op.get("description", ""):
                        return op
            return None

        slow_op = None
        if not _wait(lambda: find_slow() is not None, timeout=10.0):
            problems.append("delayed op never surfaced in "
                            "dump_historic_slow_ops")
        else:
            slow_op = find_slow()
        if slow_op is not None:
            summary["slow_op"] = {
                "description": slow_op.get("description"),
                "duration": slow_op.get("duration"),
                "dominant_stage": slow_op.get("dominant_stage"),
                "trace_entities":
                    (slow_op.get("trace") or {}).get("entities"),
                "trace_spans":
                    (slow_op.get("trace") or {}).get("num_spans"),
            }
            if not slow_op.get("stages"):
                problems.append("slow op carries no per-stage attribution")
            if not slow_op.get("dominant_stage"):
                problems.append("slow op names no dominant stage")
            trace = slow_op.get("trace") or {}
            if not trace.get("num_spans"):
                problems.append(
                    "slow op has no trace artifact (tail promotion with "
                    "trace_sampling_rate=0 failed)")
            elif len(trace.get("entities") or []) < 2:
                problems.append(
                    f"slow op's trace is not cross-entity: "
                    f"{trace.get('entities')}")

    TRACER.enable(False)
    TRACER.clear()
    summary["problems"] = problems
    print(json.dumps(summary, indent=2, default=str))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
