"""health_smoke and accounting_smoke of the port, once each on the CPU
(``--device cpu``): TPU_BACKEND_DEGRADED and KERNEL_FALLBACK_LATCHED
raise and clear; per-client byte attribution conserves the aggregate
and a failpoint-delayed op surfaces in dump_historic_slow_ops with a
tail-promoted trace."""
from __future__ import annotations

import os

from test_torch_qa_smokes import run_smoke


def test_health_smoke(capsys):
    before = os.environ.get("CEPH_TPU_SENTINEL_STATE")
    s = run_smoke("health_smoke", capsys)
    assert {"TPU_BACKEND_DEGRADED", "KERNEL_FALLBACK_LATCHED"} <= set(s["raised_checks"])
    assert os.environ.get("CEPH_TPU_SENTINEL_STATE") == before


def test_accounting_smoke(capsys):
    s = run_smoke("accounting_smoke", capsys)
    assert s["alpha_bytes_w"] > 0 and s["beta_bytes_w"] > 0
