"""The port's batch mapper (ceph_tpu_torch.crush.crush_do_rule_batch on
the CPU, where every straw2 draw runs K3's plain version) against the
JAX package's batch mapper and both packages' scalar mappers, on every
rule shape the batch path serves.  Each map is built twice from the same
steps, once by each package's builder; placements must be identical.
Maps stay small (16 hosts x 4 OSDs at most) and x runs to a few hundred,
because the reference compiles each rule shape (a few seconds each): the
cases that share a map and a rule share one reference CompiledCrushMap,
whose compiled rule is cached, and differ only in the reweight vector.
"""
import numpy as np
import pytest

from ceph_tpu.crush import builder as jax_builder
from ceph_tpu.crush import types as jax_types
from ceph_tpu.crush.mapper import CompiledCrushMap as JaxCompiled
from ceph_tpu.crush.mapper import crush_do_rule_batch as jax_batch
from ceph_tpu.crush.reference_mapper import crush_do_rule as jax_scalar
from ceph_tpu_torch.crush import builder, types
from ceph_tpu_torch.crush.mapper import CompiledCrushMap, crush_do_rule_batch
from ceph_tpu_torch.crush.reference_mapper import crush_do_rule

W = 0x10000


def _rule(t, steps):
    return t.Rule(rule_id=9, steps=[t.RuleStep(t.RuleOp[op], a1, a2) for op, a1, a2 in steps])


def _firstn(b, t):
    return b.build_hierarchical_map(16, 4), 0, 3


def _indep(b, t):
    return b.build_hierarchical_map(16, 4), 1, 4


def _racks(b, t):
    return b.build_hierarchical_map(16, 4, racks=4), 0, 3


def _multi_choose(b, t):
    cmap = b.build_hierarchical_map(16, 4, racks=4)
    cmap.rules[9] = _rule(t, [("TAKE", -1, 0), ("CHOOSE_FIRSTN", 3, 2),
                              ("CHOOSELEAF_FIRSTN", 1, 1), ("EMIT", 0, 0)])
    return cmap, 9, 3


def _choose_args(b, t):
    cmap = b.build_hierarchical_map(8, 4)
    root = cmap.buckets[-1]
    cmap.choose_args["bal"] = {
        -1: [[W + 4099 * i for i in range(root.size)],
             [3 * W - 8191 * i for i in range(root.size)]],
        -3: [[W, 0, 2 * W, W]],
    }
    return cmap, 0, 3


def _empty_bucket_indep(b, t):
    cmap = t.CrushMap()
    cmap.type_names.update({1: "host", 10: "root"})
    b.make_straw2_bucket(cmap, 1, [0, 1], [W, W], bucket_id=-2, name="host0")
    b.make_straw2_bucket(cmap, 1, [2, 3], [W, W], bucket_id=-3, name="host1")
    b.make_straw2_bucket(cmap, 1, [], [], bucket_id=-4, name="host_empty")
    b.make_straw2_bucket(cmap, 10, [-2, -3, -4], [2 * W, 2 * W, W], bucket_id=-1,
                         name="root")
    cmap.max_devices = 4
    cmap.rules[9] = _rule(t, [("TAKE", -1, 0), ("CHOOSE_INDEP", 0, 0), ("EMIT", 0, 0)])
    return cmap, 9, 3


def _no_emit(b, t):
    cmap = b.build_hierarchical_map(4, 2)
    cmap.rules[9] = _rule(t, [("TAKE", -1, 0), ("CHOOSELEAF_FIRSTN", 0, 1)])
    return cmap, 9, 2


def _set_choose_tries(b, t):
    cmap = b.build_hierarchical_map(8, 2)
    cmap.rules[9] = _rule(t, [("TAKE", -1, 0), ("SET_CHOOSE_TRIES", 13, 0),
                              ("SET_CHOOSELEAF_TRIES", 3, 0),
                              ("CHOOSELEAF_FIRSTN", 0, 1), ("EMIT", 0, 0)])
    return cmap, 9, 4


CASES = {
    "firstn": (_firstn, None, {5: 0, 7: 0x8000}),
    "indep": (_indep, None, {0: 0}),
    "racks": (_racks, None, {}),
    "multi_choose": (_multi_choose, None, {}),
    "choose_args": (_choose_args, "bal", {}),
    "reweights_with_zeros": (_firstn, None, {1: 0, 2: 0, 3: 0, 17: 0x4000, 40: 0}),
    "empty_bucket_indep": (_empty_bucket_indep, None, {}),
    "rule_without_emit": (_no_emit, None, {}),
    "set_choose_tries": (_set_choose_tries, None, {1: 0x2000, 9: 0x1000}),
}


_MAPS: dict = {}


def _maps(make):
    """(reference map, its CompiledCrushMap, port map, rule, numrep), made
    once per map builder."""
    if make not in _MAPS:
        jmap, rule, nrep = make(jax_builder, jax_types)
        tmap, _, _ = make(builder, types)
        _MAPS[make] = (jmap, JaxCompiled(jmap), tmap, rule, nrep)
    return _MAPS[make]


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_matches_reference(case):
    make, choose_args, reweight = CASES[case]
    jmap, jcm, tmap, rule, nrep = _maps(make)
    weights = np.full(tmap.max_devices, W, dtype=np.int64)
    for osd, w in reweight.items():
        weights[osd] = w
    xs = np.arange(256)
    got = crush_do_rule_batch(CompiledCrushMap(tmap, "cpu"), rule, xs, nrep, weights,
                              choose_args=choose_args).numpy()
    want = np.asarray(jax_batch(jcm, rule, xs, nrep,
                                weights.astype(np.uint32), choose_args=choose_args))
    np.testing.assert_array_equal(got, want)
    t_ca = tmap.choose_args.get(choose_args) if choose_args else None
    j_ca = jmap.choose_args.get(choose_args) if choose_args else None
    for x in range(0, 256, 3):
        exp = crush_do_rule(tmap, rule, x, nrep, list(weights), choose_args=t_ca)
        assert exp == jax_scalar(jmap, rule, x, nrep, list(weights), choose_args=j_ca)
        assert list(got[x]) == (exp + [types.ITEM_NONE] * nrep)[:nrep], x
    if case == "rule_without_emit":
        assert (got == types.ITEM_NONE).all()
    if case == "empty_bucket_indep":
        assert (got == types.ITEM_NONE).any()
