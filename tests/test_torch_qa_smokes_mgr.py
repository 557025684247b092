"""qos_smoke and placement_smoke of the port, once each on the CPU
(``--device cpu``) with their reference gates: the QoS controller's
victim p99 at least 1.5x better with no victim starved and the
aggregate within 10 %; the mgr's remap forecast within 10 % of the
observed churn, PG_IMBALANCE raised and cleared by the balancer."""
from __future__ import annotations

from test_torch_qa_smokes import run_smoke


def test_qos_smoke(capsys):
    s = run_smoke("qos_smoke", capsys)
    assert s["victim_p99_improvement"] >= 1.5
    assert s["on"]["victim_satisfaction"] >= 0.5
    assert s["aggregate_ratio"] >= 0.9


def test_placement_smoke(capsys):
    run_smoke("placement_smoke", capsys)
