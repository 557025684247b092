"""The port's qa smokes that the bench drivers feed, once each on the CPU
(``--device cpu``) with their reference gates: read_smoke (batched reads
>= 3x per-op, the cluster read scenarios, the ranged decode's k x window
bytes) and device_pool_smoke (host-copy bytes per flush <= 50 % of the
pool-off control, counted by the same seam of the port's write
batcher).  The mgr-hosted smokes are in test_torch_qa_smokes_mgr.py and
test_torch_qa_smokes_health.py, so that ``--dist loadfile`` spreads
them."""
from __future__ import annotations

import importlib
import json

import pytest

SMOKES = ("read_smoke", "device_pool_smoke", "qos_smoke", "placement_smoke",
          "health_smoke", "accounting_smoke")


def run_smoke(name: str, capsys, attempts: int = 1) -> dict:
    """main(["--device", "cpu"]) of one smoke: its JSON summary, after
    holding it to exit 0 with no problems (in one of `attempts` runs)."""
    mod = importlib.import_module(f"ceph_tpu_torch.qa.{name}")
    for _ in range(attempts):
        rc = mod.main(["--device", "cpu"])
        out = capsys.readouterr().out
        summary = json.loads(out[out.index("{"):])
        if rc == 0:
            break
    assert rc == 0, summary.get("problems")
    assert summary["problems"] == []
    return summary


def test_read_smoke(capsys):
    s = run_smoke("read_smoke", capsys)
    assert s["speedup"]["read_batch_speedup"] >= 3.0
    assert s["ranged"]["decode_bytes_in"] == s["ranged"]["expected_bytes_in"]
    assert s["get_heavy"]["mismatches"] == s["boot_storm"]["mismatches"] == 0


def test_device_pool_smoke(capsys):
    # its throughput gate compares two modes' GiB/s, which on a shared
    # CPU move with the other processes' load: a second run absorbs it,
    # as read_smoke's own speedup gate retries once (on the card, in
    # chip_smoke.py's phase 37, the smoke runs once)
    s = run_smoke("device_pool_smoke", capsys, attempts=2)
    assert s["host_copy_ratio"] <= 0.5
    assert s["pool"]["flush_sync_points"] == 0 and s["control"]["flush_sync_points"] > 0


@pytest.mark.parametrize("name", SMOKES)
def test_smokes_default_to_cuda_and_raise_without_a_card(name):
    mod = importlib.import_module(f"ceph_tpu_torch.qa.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
