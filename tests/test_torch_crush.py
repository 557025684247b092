"""The port's CRUSH placement (ceph_tpu_torch/crush, ops/crush_kernels.py)
against the JAX package on the CPU: the rjenkins hash and the crush_ln
tables, the plain versions of K3 (``ln_scores_plain`` against the Pallas
kernel in interpret mode, ``straw2_choose_plain`` against the reference's
``straw2_choose_b``), the map carried across by its text form, legacy
maps, and the device rule.  Inputs come from numpy.random.default_rng;
outputs must be identical (no tolerance).  The batch mapper's rule cases
are tests/test_torch_crush_mapper.py; the kernels themselves are held to
the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.crush import hash as jhash
from ceph_tpu.crush import ln_table as jln
from ceph_tpu.crush.batched import ln_scores_jnp, straw2_choose_b
from ceph_tpu.crush.builder import build_hierarchical_map as jax_build
from ceph_tpu.crush.builder import make_straw2_bucket as jax_bucket
from ceph_tpu.crush.mapper import CompiledCrushMap as JaxCompiled
from ceph_tpu.crush.mapper import enable_x64
from ceph_tpu.crush.types import BUCKET_LIST, BUCKET_STRAW2
from ceph_tpu.crush.types import CrushMap as JaxCrushMap
from ceph_tpu.crush.wrapper import CrushWrapper as JaxWrapper
from ceph_tpu.ops.pallas_crush import straw2_scores_pallas
from ceph_tpu_torch.crush import CrushWrapper, ITEM_NONE, crush_do_rule_batch
from ceph_tpu_torch.crush import hash as thash
from ceph_tpu_torch.crush import ln_table as tln
from ceph_tpu_torch.crush.state import wrapper_from_reference
from ceph_tpu_torch.ops import crush_kernels
from ceph_tpu_torch.ops.crush_kernels import (
    crush_ln_stream,
    ln_scores,
    ln_scores_plain,
    straw2_choose,
    straw2_choose_plain,
)


def _operands(rng, n, arity):
    """`arity` int64 columns of n values: hosts' negative bucket ids,
    values at and above 2^31, and small r."""
    cols = [rng.integers(0, 1 << 32, n), rng.integers(-(1 << 31), 1 << 31, n),
            rng.integers(0, 64, n), rng.integers(-300, 0, n)]
    return cols[:arity]


@pytest.mark.parametrize("arity", [1, 2, 3, 4])
def test_hash_matches_reference(arity):
    fns = {1: "crush_hash32", 2: "crush_hash32_2", 3: "crush_hash32_3", 4: "crush_hash32_4"}
    cols = _operands(np.random.default_rng(arity), 100_000, arity)
    u32 = [c.astype(np.uint32) for c in cols]
    with enable_x64():
        want = np.asarray(getattr(jhash, fns[arity])(*[jnp.asarray(c) for c in u32]))
    got = getattr(thash, fns[arity])(*[torch.from_numpy(c) for c in cols])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if arity in (2, 3):
        twin = getattr(jhash, fns[arity] + "_np")(*u32)
        np.testing.assert_array_equal(getattr(thash, fns[arity] + "_np")(*u32), twin)


def test_ln_tables_equal():
    np.testing.assert_array_equal(tln.CRUSH_LN_TABLE, jln.CRUSH_LN_TABLE)
    np.testing.assert_array_equal(tln.RH_LH_TBL, jln.RH_LH_TBL)
    np.testing.assert_array_equal(tln.LL_TBL, jln.LL_TBL)
    assert tln.LN_BIAS == jln.LN_BIAS
    u = torch.arange(1 << 16, dtype=torch.int32)
    np.testing.assert_array_equal(crush_ln_stream(u, "compute").numpy(), jln.CRUSH_LN_TABLE)
    np.testing.assert_array_equal(crush_ln_stream(u, "table").numpy(), jln.CRUSH_LN_TABLE)
    assert [tln.crush_ln_scalar(v) for v in (0, 1, 0x7FFF, 0xFFFF)] == [
        jln.crush_ln_scalar(v) for v in (0, 1, 0x7FFF, 0xFFFF)]


def test_ln_scores_plain_matches_pallas_interpret():
    """The TPU kernel's own output, its planes joined as (hi << 24) | lo,
    at the shape tests/test_crush_limb.py runs it."""
    rng = np.random.default_rng(5)
    B, S = 64, 128
    x = rng.integers(0, 1 << 31, B).astype(np.int32)
    r = rng.integers(0, 50, B).astype(np.int32)
    items = rng.integers(-200, 200, (B, S)).astype(np.int32)
    hi, lo = straw2_scores_pallas(jnp.asarray(x), jnp.asarray(r), jnp.asarray(items),
                                  tile=64, interpret=True)
    want = (np.asarray(hi).astype(np.int64) << 24) | np.asarray(lo).astype(np.int64)
    tx, tr, ti = (torch.from_numpy(a) for a in (x, r, items))
    np.testing.assert_array_equal(ln_scores_plain(tx, ti, tr).numpy(), want)
    np.testing.assert_array_equal(ln_scores(tx, ti, tr).numpy(), want)


def _draw_map(mod_bucket, cmap):
    """Buckets of the straw2 cases: sizes 1, 3 and 8 under a 5-wide
    parent, one zero-weight slot, and one empty bucket."""
    w = 0x10000
    mod_bucket(cmap, 1, [0], [w], bucket_id=-2)
    mod_bucket(cmap, 1, [1, 2, 3], [w, 0, 3 * w], bucket_id=-3)
    mod_bucket(cmap, 1, list(range(4, 12)), [w + 977 * i for i in range(8)], bucket_id=-4)
    mod_bucket(cmap, 1, [], [], bucket_id=-5)
    mod_bucket(cmap, 2, [-2, -3, -4, -5, 12], [w, 4 * w, 9 * w, 0, w // 2], bucket_id=-1)
    cmap.max_devices = 13
    cmap.choose_args["ws"] = {-1: [[w, 2 * w, w, 0, w], [0, w, 5 * w, w, 3 * w]],
                              -4: [[w * (8 - i) for i in range(8)]]}
    return cmap


@pytest.mark.parametrize("choose_args", [None, "ws"])
def test_straw2_choose_plain_matches_reference(choose_args):
    from ceph_tpu_torch.crush.builder import make_straw2_bucket
    from ceph_tpu_torch.crush.mapper import CompiledCrushMap
    from ceph_tpu_torch.crush.types import CrushMap

    jcm = JaxCompiled(_draw_map(jax_bucket, JaxCrushMap()))
    tcm = CompiledCrushMap(_draw_map(make_straw2_bucket, CrushMap()), "cpu")
    rng = np.random.default_rng(11)
    B = 4096
    bidx = rng.integers(0, 5, B).astype(np.int32)
    x = rng.integers(-(1 << 31), 1 << 31, B).astype(np.int32)
    r = rng.integers(0, 100, B).astype(np.int32)
    pos = rng.integers(0, 4, B).astype(np.int32)
    with enable_x64():
        cw = None if choose_args is None else jcm.choose_args_arrays(choose_args)
        want = np.asarray(straw2_choose_b(
            jcm, ln_scores_jnp, jnp.asarray(bidx), jnp.asarray(x), jnp.asarray(r),
            cw, jnp.asarray(pos)))
    weights = (tcm.weights if choose_args is None
               else tcm.choose_args_arrays(choose_args).reshape(-1, tcm.max_size))
    args = (tcm.items, weights, tcm.sizes) + tuple(
        torch.from_numpy(a) for a in (bidx, x, r, pos))
    got = straw2_choose_plain(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(straw2_choose(*args), got)
    assert (want[bidx == 4] == ITEM_NONE).all()  # the empty bucket
    assert not (want == 2).any()  # the zero-weight slot never wins


def test_wrapper_from_reference_carries_text_and_arrays():
    jmap = jax_build(16, 4, racks=4)
    jw = JaxWrapper(jmap)
    root = jmap.buckets[-1]
    rng = np.random.default_rng(3)
    ws = [[int(v) for v in rng.integers(1, 0x30000, root.size)] for _ in range(2)]
    jw.set_choose_args("bal", -1, ws)
    tw = wrapper_from_reference(jw.format_text(), jmap.choose_args)
    assert tw.format_text() == jw.format_text()
    assert tw.map.choose_args == jmap.choose_args
    jc, tc = jw.compiled(), tw.compiled("cpu")
    for name in ("_np_items", "_np_weights", "_np_sizes", "_np_types"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    np.testing.assert_array_equal(tc.items.numpy(), jc._np_items)
    np.testing.assert_array_equal(tc.weights.numpy(), jc._np_weights)
    with enable_x64():
        want = np.asarray(jc.choose_args_arrays("bal"))
    np.testing.assert_array_equal(tc.choose_args_arrays("bal").numpy(), want)
    weights = [0x10000] * 64
    for x in range(0, 4000, 97):
        assert tw.do_rule(0, x, 3, weights, "bal") == jw.do_rule(0, x, 3, weights, "bal")


def test_legacy_map_batch_raises_and_scalar_matches():
    from ceph_tpu_torch.crush.builder import add_simple_rule, make_straw2_bucket
    from ceph_tpu_torch.crush.types import CrushMap

    def build(cmap, bucket, rule):
        hids = [bucket(cmap, 1, [3 * h, 3 * h + 1, 3 * h + 2],
                       [0x10000 * (1 + (h + i) % 3) for i in range(3)],
                       name=f"host{h}", alg=BUCKET_LIST).id for h in range(4)]
        root = bucket(cmap, 2, hids, [cmap.buckets[h].weight for h in hids],
                      name="root", alg=BUCKET_STRAW2)
        rule(cmap, root.id, 1, rule_id=0)
        return cmap

    from ceph_tpu.crush.builder import add_simple_rule as jax_rule

    jw = JaxWrapper(build(JaxCrushMap(type_names={0: "osd", 1: "host", 2: "root"}),
                          jax_bucket, jax_rule))
    tw = CrushWrapper(build(CrushMap(type_names={0: "osd", 1: "host", 2: "root"}),
                            make_straw2_bucket, add_simple_rule))
    assert tw.format_text() == jw.format_text()
    weights = [0x10000] * 12
    with pytest.raises(NotImplementedError):
        tw.do_rule_batch(0, np.arange(8), 3, weights, device="cpu")
    for x in range(200):
        assert tw.do_rule(0, x, 3, weights) == jw.do_rule(0, x, 3, weights)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from ceph_tpu_torch.crush.builder import build_hierarchical_map

    w = CrushWrapper(build_hierarchical_map(4, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        w.do_rule_batch(0, np.arange(4), 3, [0x10000] * 8)
    got = w.do_rule_batch(0, np.arange(4), 3, [0x10000] * 8, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int32


def test_kernel_wrappers_check_their_inputs():
    items = torch.zeros((2, 4), dtype=torch.int32)
    weights = torch.ones((2, 4), dtype=torch.int64)
    sizes = torch.full((2,), 4, dtype=torch.int32)
    lanes = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        straw2_choose(items, weights.int(), sizes, lanes, lanes, lanes, lanes)
    with pytest.raises(ValueError):
        straw2_choose(items, weights[:, :3].contiguous(), sizes, lanes, lanes, lanes, lanes)
    with pytest.raises(ValueError):
        straw2_choose(items, weights, sizes, lanes, lanes[:2], lanes, lanes)
    with pytest.raises(ValueError):
        crush_ln_stream(lanes, "onehot")
    before = dict(crush_kernels.LAUNCHES)
    straw2_choose(items, weights, sizes, lanes, lanes, lanes, lanes)
    assert crush_kernels.LAUNCHES == before  # the CPU runs the plain version


def test_batch_result_is_on_the_map_device():
    from ceph_tpu_torch.crush.builder import build_hierarchical_map
    from ceph_tpu_torch.crush.mapper import CompiledCrushMap

    cm = CompiledCrushMap(build_hierarchical_map(4, 2), "cpu")
    out = crush_do_rule_batch(cm, 0, torch.arange(10), 3, np.full(8, 0x10000))
    assert out.shape == (10, 3) and out.dtype == torch.int32
