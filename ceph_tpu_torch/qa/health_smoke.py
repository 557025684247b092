"""Backend-health CI smoke: forced wedge -> health checks raise ->
recovery -> checks clear (the port's counterpart of
ceph_tpu/qa/health_smoke.py).  The cluster runs on the device
``--device`` names (``cuda`` by default, ``cpu`` on request).

    python -m ceph_tpu_torch.qa.health_smoke [--device cpu]

Drives the WHOLE surface through the production path, no shortcuts:

1. arm the simulated wedge through the sentinel's env probe override
   (``CEPH_TPU_SENTINEL_STATE=degraded:...`` — the probe never touches
   the device) and inject a fallback latch through the telemetry
   registry (the port has no fallback path: the latch is recorded
   directly, as the reference's smoke records it);
2. start a LocalCluster (mgr hosted) with a fast sentinel cadence and
   wait for ``health detail`` to report **TPU_BACKEND_DEGRADED** and
   **KERNEL_FALLBACK_LATCHED** — i.e. OSD probe -> `_mgr_report` ->
   status-module digest -> mon `_health`, end to end;
3. scrape the mgr prometheus exporter and assert ``ceph_health_status``
   is 1 (WARN) with a ``ceph_health_detail`` series per check;
4. smoke-check the ``dump_kernel_telemetry`` admin-command JSON schema
   over a real admin socket;
5. flip the probe override to ``ok`` + clear the fallback latch through
   the telemetry registry that recorded it (the port's admin socket has
   no ``clear_kernel_fallback``: it has no fallback to clear), and wait
   for BOTH checks to clear.

Exit 0 on success; 1 with a `problems` list otherwise.  Prints one JSON
summary on stdout.  The sentinel override is restored on exit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


from .smoke_util import assert_no_leaked_threads, wait_for as _wait


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.qa.health_smoke",
        description="backend health checks raise and clear end to end")
    ap.add_argument("--device", default="cuda",
                    help="the cluster's device (default: cuda)")
    args = ap.parse_args(argv)

    from ..common.device import resolve_device

    device = resolve_device(args.device)  # raises without a card
    prior = os.environ.get("CEPH_TPU_SENTINEL_STATE")
    try:
        return _run(device)
    finally:
        if prior is None:
            os.environ.pop("CEPH_TPU_SENTINEL_STATE", None)
        else:
            os.environ["CEPH_TPU_SENTINEL_STATE"] = prior


def _run(device) -> int:
    os.environ["CEPH_TPU_SENTINEL_STATE"] = "degraded:ci simulated wedge"

    from ..common.admin_socket import admin_socket_command
    from ..common.kernel_telemetry import TELEMETRY
    from ..qa.vstart import LocalCluster

    problems: list[str] = []
    summary: dict = {}
    TELEMETRY.record_fallback(
        "gf_apply", "simulated kernel failure", frm="cuda", to="cpu")

    import tempfile

    asok_dir = tempfile.mkdtemp(prefix="ceph_tpu_health_")
    overrides = {
        "backend_sentinel_interval": 0.2,
        "backend_sentinel_timeout": 0.5,
        "mgr_report_interval": 0.2,
        "mgr_digest_interval": 0.2,
        "mgr_stale_report_age": 30.0,
        "admin_socket": os.path.join(asok_dir, "$name.asok"),
    }

    def checks() -> dict:
        rv, res = c.mon_command({"prefix": "health detail"})
        if rv != 0 or not isinstance(res, dict):
            return {}
        return (res.get("health") or {}).get("checks") or {}

    # Runtime twin of the CL13/CL14 lints: every thread bring-up starts
    # must be gone after teardown.  Held open across the whole cluster
    # lifecycle; closed below so a leak lands in `problems` (the JSON
    # summary still renders) instead of a bare traceback.
    leak_gate = contextlib.ExitStack()
    leak_gate.enter_context(assert_no_leaked_threads())
    with LocalCluster(n_mons=1, n_osds=2, with_mgr=True,
                      conf_overrides=overrides, device=device) as c:
        # -- raise ----------------------------------------------------
        if not _wait(lambda: {"TPU_BACKEND_DEGRADED",
                              "KERNEL_FALLBACK_LATCHED"} <= set(checks()),
                     timeout=20.0):
            problems.append(
                f"wedged checks did not raise; got {sorted(checks())}")
        summary["raised_checks"] = sorted(checks())

        # -- prometheus while degraded --------------------------------
        try:
            import urllib.request

            url = c.mgr.module("prometheus").url
            body = urllib.request.urlopen(url, timeout=10).read().decode()
            if "ceph_health_status 1" not in body:
                problems.append("prometheus: ceph_health_status != 1 "
                                "while degraded")
            for name in ("TPU_BACKEND_DEGRADED", "KERNEL_FALLBACK_LATCHED"):
                if f'ceph_health_detail{{name="{name}"' not in body:
                    problems.append(f"prometheus: no ceph_health_detail "
                                    f"series for {name}")
        except Exception as e:
            problems.append(f"prometheus scrape failed: {e!r}")

        # -- dump_kernel_telemetry schema over the admin socket -------
        asok = os.path.join(asok_dir, "osd.0.asok")
        try:
            dump = admin_socket_command(asok, "dump_kernel_telemetry")
            for key in ("enabled", "kernels", "fallback", "sentinel",
                        "events"):
                if key not in dump:
                    problems.append(
                        f"dump_kernel_telemetry missing {key!r}")
            if (dump.get("sentinel") or {}).get("state") != "degraded":
                problems.append("dump_kernel_telemetry sentinel state "
                                f"!= degraded: {dump.get('sentinel')}")
            if "gf_apply" not in (dump.get("fallback") or {}):
                problems.append("dump_kernel_telemetry fallback latch "
                                "missing gf_apply")
            summary["telemetry_kernels"] = sorted(dump.get("kernels") or {})
        except Exception as e:
            problems.append(f"dump_kernel_telemetry failed: {e!r}")

        # -- recover --------------------------------------------------
        os.environ["CEPH_TPU_SENTINEL_STATE"] = "ok"
        if not TELEMETRY.clear_fallback():
            problems.append("the injected fallback latch was not latched")
        if not _wait(lambda: not ({"TPU_BACKEND_DEGRADED",
                                   "KERNEL_FALLBACK_LATCHED"}
                                  & set(checks())), timeout=20.0):
            problems.append(
                f"checks did not clear after recovery; "
                f"still {sorted(checks())}")
        summary["cleared_checks"] = sorted(checks())

    try:
        leak_gate.close()
    except AssertionError as e:
        problems.append(str(e))

    summary["problems"] = problems
    print(json.dumps(summary, indent=2, default=str))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
