"""The port's bench drivers and the CRUSH oracle bridge against the JAX
reference on the CPU: crush/oracle_bridge.py, bench/timing.py,
bench/ec_bench.py, bench/crush_bench.py and bench/baseline.py.  Bytes,
placements and counts are compared; times never are."""
from __future__ import annotations

import json

import numpy as np
import pytest

import ceph_tpu.crush.builder as ref_builder
import ceph_tpu.crush.types as ref_types
import ceph_tpu_torch.crush.builder as port_builder
import ceph_tpu_torch.crush.types as port_types
from ceph_tpu.crush.oracle_bridge import do_rule_batch_oracle as ref_oracle
from ceph_tpu_torch.crush import oracle_bridge
from ceph_tpu_torch.crush.reference_mapper import crush_do_rule

ALGS = ("BUCKET_UNIFORM", "BUCKET_LIST", "BUCKET_TREE", "BUCKET_STRAW", "BUCKET_STRAW2")


def _mixed_map(builder, types, alg_name: str, hosts: int = 4, per: int = 3):
    """hosts of one bucket algorithm under a straw2 root, rules 0
    (firstn) and 1 (indep) choosing leaves by host: the shape of
    test_crush_legacy_buckets.py's maps, built by either package."""
    alg = getattr(types, alg_name)
    cmap = types.CrushMap(type_names={0: "osd", 1: "host", 2: "root"})
    hids = []
    for h in range(hosts):
        ws = ([0x10000] * per if alg == types.BUCKET_UNIFORM
              else [0x10000 * (1 + (h + i) % 3) for i in range(per)])
        hids.append(builder.make_straw2_bucket(
            cmap, 1, [h * per + i for i in range(per)], ws, name=f"host{h}", alg=alg).id)
    root = builder.make_straw2_bucket(cmap, 2, hids, [cmap.buckets[h].weight for h in hids],
                                      name="root", alg=types.BUCKET_STRAW2)
    builder.add_simple_rule(cmap, root.id, 1, rule_id=0, firstn=True)
    builder.add_simple_rule(cmap, root.id, 1, rule_id=1, firstn=False)
    return cmap


@pytest.mark.parametrize("alg_name", ALGS)
@pytest.mark.parametrize("rule", [0, 1])
def test_oracle_bridge_matches_the_reference_bridge_and_the_scalar_mapper(alg_name, rule):
    w = np.full(12, 0x10000, dtype=np.uint32)
    w[4] = 0  # one OSD out
    xs = np.arange(3000)
    got = oracle_bridge.do_rule_batch_oracle(
        _mixed_map(port_builder, port_types, alg_name), rule, xs, 3, w)
    want = ref_oracle(_mixed_map(ref_builder, ref_types, alg_name), rule, xs, 3, w)
    assert got.dtype == np.int32 and got.shape == (3000, 3)
    assert np.array_equal(got, want)
    cmap = _mixed_map(port_builder, port_types, alg_name)
    for x in range(0, 3000, 97):
        row = crush_do_rule(cmap, rule, x, 3, w)
        assert list(got[x, : len(row)]) == list(row), x


def test_oracle_bridge_on_the_hierarchical_map_and_a_multi_choose_rule():
    from ceph_tpu.crush import build_hierarchical_map as ref_map
    from ceph_tpu_torch.crush import build_hierarchical_map as port_map

    w = np.full(64, 0x10000, dtype=np.uint32)
    xs = np.arange(20000, dtype=np.int64)
    for rule, numrep in ((0, 3), (1, 6)):
        assert np.array_equal(
            oracle_bridge.do_rule_batch_oracle(port_map(16, 4), rule, xs, numrep, w),
            ref_oracle(ref_map(16, 4), rule, xs, numrep, w))
    # a TAKE / CHOOSE 2 host / CHOOSE 1 osd / EMIT chain: the step
    # interpreter (do_rule_steps_oracle), against the scalar mapper
    cmap = port_map(16, 4)
    root = cmap.rules[0].steps[0].arg1
    rule = port_types.Rule(rule_id=7, steps=[
        port_types.RuleStep(port_types.RuleOp.TAKE, root, 0),
        port_types.RuleStep(port_types.RuleOp.CHOOSE_FIRSTN, 2, 1),
        port_types.RuleStep(port_types.RuleOp.CHOOSE_FIRSTN, 1, 0),
        port_types.RuleStep(port_types.RuleOp.EMIT, 0, 0)])
    cmap.rules[7] = rule
    got = oracle_bridge.do_rule_batch_oracle(cmap, 7, xs[:500], 2, w)
    for x in range(0, 500, 23):
        assert list(got[x]) == list(crush_do_rule(cmap, 7, x, 2, w)), x


def test_oracle_bridge_hash_and_ln_match_the_reference():
    from ceph_tpu.crush import oracle_bridge as ref

    assert np.array_equal(oracle_bridge.ln_table_full(), ref.ln_table_full())
    for a, b, c in ((0, 0, 0), (1, 2, 3), (0xFFFFFFFF, 7, 0x12345678), (-1, 5, 9)):
        assert oracle_bridge.hash3(a, b, c) == ref.hash3(a, b, c)
        assert oracle_bridge.hash2(a, b) == ref.hash2(a, b)
    for u in (0, 1, 0x8000, 0xFFFF):
        assert oracle_bridge.crush_ln(u) == ref.crush_ln(u)


# ---- bench/timing.py ------------------------------------------------------


def _matrices():
    from ceph_tpu_torch.bench.baseline import clay_setup, shec_setup
    from ceph_tpu_torch.gf.matrix import cauchy_good_coding_matrix, vandermonde_coding_matrix

    yield "rs84", np.ascontiguousarray(cauchy_good_coding_matrix(8, 4), np.uint8)
    yield "rs21", np.ascontiguousarray(vandermonde_coding_matrix(2, 1), np.uint8)
    yield "shec", shec_setup("cpu")[0]
    yield "clay", clay_setup("cpu", chunk_mib=1)[0]


@pytest.mark.parametrize("name,mat", list(_matrices()), ids=lambda v: v if isinstance(v, str) else "")
def test_chained_encode_matches_the_reference_after_n_iterations(name, mat):
    from ceph_tpu.bench.timing import make_chained_encode as ref_make
    from ceph_tpu_torch.bench.timing import make_chained_encode

    x = np.random.default_rng(3).integers(0, 256, (mat.shape[1], 3000), dtype=np.uint8)
    ref_loop, ref_prep = ref_make(mat, kernel="xla")
    want = np.asarray(ref_loop(ref_prep(x), 5))
    loop, prep = make_chained_encode(mat, device="cpu")
    got = loop(prep(x), 5).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, x)  # the chain moved the bytes


def test_time_chained_encode_labels_the_cpu_clock():
    from ceph_tpu_torch.bench.timing import time_chained_encode

    mat = dict(_matrices())["rs84"]
    x = np.random.default_rng(4).integers(0, 256, (8, 4096), dtype=np.uint8)
    t = time_chained_encode(mat, x, 3, device="cpu", subtract_overhead=True, repeats=2)
    assert t.device == "cpu" and t.seconds > 0


# ---- bench/ec_bench.py ----------------------------------------------------


def _ec(argv, capsys, ref=False):
    if ref:
        from ceph_tpu.bench.ec_bench import main
        argv = [a if a != "torch" else "jax" for a in argv]
    else:
        from ceph_tpu_torch.bench.ec_bench import main
        argv = argv + ["--device", "cpu"]
    assert main(argv + ["--json"]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("argv", [
    ["encode", "-P", "torch", "-p", "k=8", "-p", "m=4", "-p", "technique=cauchy_good",
     "-s", "65536", "-i", "3"],
    ["encode", "-P", "shec", "-p", "k=6", "-p", "m=3", "-p", "c=2", "-s", "65536", "-i", "2"],
    ["decode", "-P", "torch", "-p", "k=4", "-p", "m=2", "-s", "65536", "-i", "4", "-e", "2"],
    ["decode", "-P", "torch", "-p", "k=4", "-p", "m=2", "-s", "8192", "-i", "6",
     "--erasures-generation", "exhaustive"],
    ["rmw", "-P", "torch", "-p", "k=4", "-p", "m=2", "-i", "3", "--rmw-width", "1024"],
    ["encode", "-P", "torch", "-p", "k=2", "-p", "m=1", "-s", "65536", "--stream", "3"],
], ids=["encode-rs84", "encode-shec", "decode-random", "decode-exhaustive", "rmw", "stream"])
def test_ec_bench_counts_match_the_reference(argv, capsys):
    from ceph_tpu_torch.bench import ec_bench

    got = _ec(argv, capsys)
    want = _ec(argv, capsys, ref=True)
    assert got["bytes"] == want["bytes"] and got["seconds"] > 0
    assert got["profile"] == {**want["profile"], "plugin": got["profile"]["plugin"]}
    assert got["device"] == "cpu" and got["clock"] == "host"
    res = ec_bench.LAST_RESULT
    if argv[0] == "decode":
        # the same seeded erasure patterns as the reference's generator,
        # and every decode returns the data
        import itertools

        rng = np.random.default_rng(0)
        k, m = 4, 2
        data = rng.integers(0, 256, (k, len(res["decoded"][0])), dtype=np.uint8)
        if "exhaustive" in argv:
            want_pat = [sorted(p) for p in itertools.islice(itertools.cycle(
                itertools.combinations(range(k + m), 1)), len(res["erasures"]))]
        else:
            want_pat = [sorted(int(v) for v in rng.choice(k + m, size=2, replace=False))
                        for _ in res["erasures"]]
        assert res["erasures"] == want_pat
        for j in range(k):
            assert np.array_equal(res["decoded"][j].numpy(), data[j])
    if "--stream" in argv:
        from ceph_tpu_torch.gf.reference_codec import encode_chunks
        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

        codec = ErasureCodePluginRegistry.instance().factory(
            {"plugin": "torch", "k": "2", "m": "1"}, device="cpu")
        rng = np.random.default_rng(0)
        L = codec.get_chunk_size(65536)
        rng.integers(0, 256, (2, L), dtype=np.uint8)  # the chunks drawn first
        for parity in res["parity"]:
            batch = rng.integers(0, 256, (2, L), dtype=np.uint8)
            assert np.array_equal(parity, encode_chunks(codec.coding, batch))


# ---- bench/crush_bench.py -------------------------------------------------


def test_crush_bench_both_is_bit_exact_and_samples_like_the_reference(capsys):
    """--backend both compares the oracle's whole batch; its sample rows
    are the reference package's placements (its C++ oracle bridge, which
    its own crush_bench holds bit-exact to its batch mapper)."""
    from ceph_tpu.crush import build_hierarchical_map as ref_map
    from ceph_tpu_torch.bench.crush_bench import main

    args = ["--osds", "64", "--hosts", "16", "--num-pgs", "6000", "--json"]
    w = np.full(64, 0x10000, dtype=np.uint32)
    for rule, numrep in ((0, 3), (1, 6)):
        argv = args + ["--rule", str(rule), "--numrep", str(numrep)]
        assert main(argv + ["--backend", "both", "--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out)
        assert got["bit_exact_vs_oracle"] is True and got["oracle_compared"] == 6000
        want = ref_oracle(ref_map(16, 4), rule, np.arange(2), numrep, w)
        assert got["sample"] == want.tolist()


# ---- bench/baseline.py ----------------------------------------------------


def test_baseline_on_the_cpu_holds_its_byte_checks():
    import bench as ref_bench
    from ceph_tpu_torch.bench import baseline

    res = baseline.run("cpu", data_mib=1, iters=2, crush_pgs=5000, traffic_clients=2,
                       traffic_seconds=0.3, chunk_mib=1, clay_chunk_mib=1)
    assert res["device"] == "cpu" and res["card"] is None
    cfg = {c["config"]: c for c in res["configs"]}
    assert sorted(cfg) == [1, 2, 3, 4, 5]
    for c in (1, 2, 3, 4):
        assert cfg[c]["bytes_equal"] and cfg[c]["clock"] == "host" and cfg[c]["gibps"] > 0
    assert cfg[5]["bit_exact_vs_oracle"] and cfg[5]["oracle_checked"] == 5000
    # the same matrices, plans and repair fraction as bench.py's
    M, avail = ref_bench._shec_matrix()
    assert np.array_equal(baseline.shec_setup("cpu")[0], M)
    assert cfg[3]["reads_chunks"] == len(avail)
    Mc, chunk, sub_len, helpers, codec = ref_bench._clay_setup()
    assert np.array_equal(baseline.clay_setup("cpu")[0], Mc)
    need = codec.minimum_to_decode({0}, set(helpers))
    fetched = sum(chunk if ln == -1 else ln * sub_len for r in need.values() for _o, ln in r)
    assert cfg[4]["repair_bw_frac_of_naive"] == fetched / (codec.k * chunk)
    assert res["traffic"]["traffic_rs"] == "8+4"
    assert res["traffic"]["traffic_batched_ops"] > 0 and res["traffic"]["traffic_perop_ops"] > 0


def test_check_chain_catches_a_wrong_byte(monkeypatch):
    from ceph_tpu_torch.bench import baseline, timing

    mat = dict(_matrices())["rs84"]
    x = np.random.default_rng(6).integers(0, 256, (8, 512), dtype=np.uint8)
    baseline.check_chain(mat, x, "cpu")
    make = timing.make_chained_encode

    def off_by_one(coding, device=None):
        loop, prep = make(coding, device)

        def bad(t, iters):
            out = loop(t, iters)
            out[0, 7] ^= 1
            return out
        return bad, prep

    monkeypatch.setattr(timing, "make_chained_encode", off_by_one)
    with pytest.raises(AssertionError, match="numpy codec"):
        baseline.check_chain(mat, x, "cpu")


@pytest.mark.parametrize("module,argv", [
    ("ceph_tpu_torch.bench.ec_bench", ["encode"]),
    ("ceph_tpu_torch.bench.crush_bench", ["--num-pgs", "10"]),
    ("ceph_tpu_torch.bench.traffic", ["--seconds", "0.1"]),
    ("ceph_tpu_torch.bench.baseline", []),
])
def test_entry_points_default_to_cuda_and_raise_without_a_card(module, argv):
    import importlib

    main = importlib.import_module(module).main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
