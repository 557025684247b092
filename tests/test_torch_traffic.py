"""bench/traffic.py of the port against the JAX reference on the CPU:
the seeded streams, the stat helpers and the tenant vocabulary give the
same values; run_traffic and run_read_traffic run at a tiny size through
the port's batchers and report the reference's fields, and their inputs
(stripe pools, decode matrices, survivor stacks) are the reference's
bytes.  Times are never compared.  The two traffic-scenario soaks run
behind ``-m slow``, as in the reference."""
from __future__ import annotations

import numpy as np
import pytest

import ceph_tpu.bench.traffic as ref
import ceph_tpu_torch.bench.traffic as port


@pytest.mark.parametrize("stream", sorted(port._SEED_STREAMS))
def test_derive_rng_draws_the_reference_streams(stream):
    assert port._SEED_STREAMS == ref._SEED_STREAMS
    for seed, index in ((port.DEFAULT_SEED, 0), (7, 3), (2**31, 17)):
        a = port.derive_rng(seed, stream, index)
        b = ref.derive_rng(seed, stream, index)
        assert np.array_equal(a.integers(0, 256, 64), b.integers(0, 256, 64))
        assert a.exponential(0.01) == b.exponential(0.01)


def test_stage_breakdown_per_client_stats_and_chunk_len_match():
    rng = np.random.default_rng(9)
    stages = port.OP_STAGES
    assert stages == ref.OP_STAGES
    spans = [{"name": stages[i % len(stages)], "dur_ms": float(d)}
             for i, d in enumerate(rng.exponential(3.0, 200))]
    spans += [{"name": "other", "dur_ms": 1.0}, {"name": stages[0], "dur_ms": None}]
    assert port.stage_breakdown(spans) == ref.stage_breakdown(spans)
    lats = [list(rng.exponential(0.002, n)) for n in (5, 17, 1)]
    assert port.per_client_stats(lats) == ref.per_client_stats(lats)
    # a starved client forces fairness None in both
    assert port.per_client_stats(lats + [[]]) == ref.per_client_stats(lats + [[]])
    assert port.per_client_stats(lats + [[]])[1] is None
    for size, k in ((4096, 8), (1000, 3), (1, 2), (1 << 20, 4)):
        assert port._chunk_len(size, k) == ref._chunk_len(size, k)
    assert port._pctiles([]) == ref._pctiles([]) == (None, None)


@pytest.mark.parametrize("kind", port.TENANT_KINDS)
def test_tenant_vocabulary_matches(kind):
    assert port.TENANT_MIX == ref.TENANT_MIX
    objs = port.tenant_objects(kind, "t0", 64)
    assert objs == ref.tenant_objects(kind, "t0", 64)
    for t in np.linspace(0.0, 1.5, 31):
        assert port.arrival_intensity(kind, float(t)) == ref.arrival_intensity(kind, float(t))
    a, b = port.derive_rng(5, "tenant", 2), ref.derive_rng(5, "tenant", 2)
    ops_a = [port.tenant_next_op(kind, a, objs, i / 200) for i in range(200)]
    ops_b = [ref.tenant_next_op(kind, b, objs, i / 200) for i in range(200)]
    assert ops_a == ops_b and any(op is not None for op in ops_a)
    with pytest.raises(ValueError):
        port.tenant_objects("nfs", "t0", 1)


@pytest.mark.parametrize("mode", ["perop", "batched"])
def test_run_traffic_tiny(mode):
    res = port.run_traffic(mode, n_clients=3, seconds=0.4, warmup=0.1, k=4, m=2,
                           device="cpu")
    want = ref.run_traffic(mode, n_clients=3, seconds=0.4, warmup=0.1, k=4, m=2)
    assert set(res) == set(want)
    assert res["mode"] == mode and res["seed"] == port.DEFAULT_SEED
    assert res["ops"] > 0 and res["gibps"] > 0
    assert sum(r["ops"] for r in res["per_client"].values()) == res["ops"]
    if mode == "perop":
        # every op encodes inline: no flush, as in the reference
        assert res["flushes"] == want["flushes"] == 0
    else:
        assert res["flushes"] > 0 and res["stripes_per_flush"] >= 1.0


def test_run_traffic_poisson_and_traced():
    res = port.run_traffic("batched", n_clients=2, seconds=0.4, warmup=0.1, k=2, m=1,
                           arrivals="poisson", rate=200.0, sampling=1.0, device="cpu")
    assert res["arrivals"] == "poisson" and res["target_rate"] == 200.0
    assert res["sched_lag_ms"] >= 0 and res["ops"] > 0
    assert res["traces"] > 0 and "encode" in res["stages"]


def test_traffic_inputs_are_the_references_bytes():
    """The stripe pool, and the read path's decode matrix and survivor
    stacks, built as run_traffic and run_read_traffic build them."""
    from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefReg
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    a, b = port.derive_rng(3, "stripes"), ref.derive_rng(3, "stripes")
    L = port._chunk_len(4096, 8)
    for _ in range(8):
        assert np.array_equal(a.integers(0, 256, (8, L), dtype=np.uint8),
                              b.integers(0, 256, (8, L), dtype=np.uint8))
    codec = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "torch", "k": "4", "m": "2"}, device="cpu")
    rcodec = RefReg.instance().factory({"plugin": "jax", "k": "4", "m": "2"})
    rows = (0, 2, 3, 4)
    dm, _ = codec.bitplane._decode_entry(rows)
    rdm, _ = rcodec._jax_codec._decode_entry(rows)
    assert np.array_equal(dm, rdm)
    x = port.derive_rng(3, "read_stacks").integers(0, 256, (4, 256), dtype=np.uint8)
    assert np.array_equal(codec.encode_chunks(x).numpy(),
                          np.asarray(rcodec.encode_chunks(x), np.uint8))


def test_run_read_traffic_tiny():
    res = port.run_read_traffic("batched", n_clients=3, seconds=0.4, warmup=0.1,
                                device="cpu")
    want = ref.run_read_traffic("batched", n_clients=3, seconds=0.4, warmup=0.1)
    assert set(res) == set(want)
    assert res["ops"] > 0 and res["flushes"] > 0 and res["decode_groups"] > 0
    assert res["rs"] == want["rs"] == "4+2"


# -- soaks -----------------------------------------------------------------


@pytest.mark.slow
def test_traffic_scenario_batched_speedup():
    """The port's twin of test_write_batcher.py's soak: sustained 4 KiB
    writes from 32 async clients on the CPU, batched >= 3x per-op."""
    res = port.run_scenario(n_clients=32, seconds=2.0, write_size=4096, device="cpu")
    assert res["traffic_batched_gibps"] > 0
    assert res["traffic_batch_speedup"] >= 3.0, res
    assert res["traffic_batched_p99_ms"] is not None


@pytest.mark.slow
def test_traffic_scenario_batched_read_speedup():
    """The port's twin of test_read_batcher.py's soak: degraded 1 KiB
    reads from 32 async clients, batched >= 3x per-op, best of 3."""
    best = {"read_batch_speedup": 0.0}
    for _ in range(3):
        res = port.run_read_scenario(n_clients=32, seconds=2.0, read_size=1024,
                                     device="cpu")
        assert res["read_batched_gibps"] > 0
        if res["read_batch_speedup"] > best["read_batch_speedup"]:
            best = res
        if best["read_batch_speedup"] >= 3.0:
            break
    assert best["read_batch_speedup"] >= 3.0, best
