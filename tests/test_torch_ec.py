"""The port's codec layer (ceph_tpu_torch/ec) against the JAX package's.

The same inputs, made with numpy from a seed, go through the registry of
each package on the CPU (``plugin=torch`` with ``device="cpu"`` against
``plugin=jax``); bytes must be identical.  Also: the port's matrix
construction equals the reference's byte for byte, shards written by one
package decode under the other (``ec/state.codec_from_arrays`` carries the
matrices across), and an entry point left on its default device raises
when there is no card.
"""
import numpy as np
import pytest
import torch

from ceph_tpu import gf as jgf
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch import gf as tgf
from ceph_tpu_torch.ec.interface import InvalidProfile
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry as TorchRegistry
from ceph_tpu_torch.ec.state import codec_from_arrays, repair_matrix_name
from ceph_tpu_torch.ops.gf_kernels import k2_layout, kernel_for

CPU = "cpu"


def _jax(profile):
    return JaxRegistry.instance().factory(profile)


def _torch(profile):
    return TorchRegistry.instance().factory(profile, device=CPU)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(_np(a[key]), _np(b[key]))


RS_PROFILES = [
    {"technique": "reed_sol_van", "k": "4", "m": "2"},
    {"technique": "reed_sol_r6_op", "k": "4", "m": "2"},
    {"technique": "cauchy_orig", "k": "6", "m": "3"},
    {"technique": "cauchy_good", "k": "8", "m": "4"},
]


@pytest.mark.parametrize("profile", RS_PROFILES, ids=lambda p: p["technique"])
def test_rs_torch_plugin_matches_jax_plugin(profile):
    rng = np.random.default_rng(len(profile["technique"]))
    data = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    jc = _jax({**profile, "plugin": "jax"})
    tc = _torch({**profile, "plugin": "torch"})
    n = jc.get_chunk_count()
    enc_j, enc_t = jc.encode(set(range(n)), data), tc.encode(set(range(n)), data)
    _same(enc_j, enc_t)
    k = jc.get_data_chunk_count()
    lost = {0, n - 1}
    have_j = {c: v for c, v in enc_j.items() if c not in lost}
    have_t = {c: v for c, v in enc_t.items() if c not in lost}
    size = len(enc_j[0])
    _same(jc.decode(set(range(n)), have_j, size), tc.decode(set(range(n)), have_t, size))
    assert tc.decode_concat(have_t)[: len(data)] == data
    assert k == tc.get_data_chunk_count()


def test_numpy_referee_matches_torch_plugin():
    profile = {"technique": "cauchy_good", "k": "5", "m": "3"}
    data = np.random.default_rng(2).integers(0, 256, 7777, dtype=np.uint8).tobytes()
    a = _torch({**profile, "plugin": "numpy"}).encode(set(range(8)), data)
    b = _torch({**profile, "plugin": "torch"}).encode(set(range(8)), data)
    _same(a, b)


def test_bitmatrix_techniques_wait_for_their_slice():
    with pytest.raises(InvalidProfile, match="not ported"):
        _torch({"technique": "liberation", "k": "4", "m": "2"})


def test_shec_decode_matches_jax():
    profile = {"plugin": "shec", "k": "6", "m": "3", "c": "2"}
    jc, tc = _jax(profile), _torch(profile)
    data = np.random.default_rng(6).integers(0, 256, (6, 1024), dtype=np.uint8)
    pj, pt = jc.encode_chunks(data), tc.encode_chunks(data)
    np.testing.assert_array_equal(_np(pj), _np(pt))
    chunks = {i: data[i] for i in range(6)}
    chunks.update({6 + i: _np(pj)[i] for i in range(3)})
    for want in ({2}, {0, 7}):
        avail = set(chunks) - want
        need = jc.minimum_to_decode(want, avail)
        assert tc.minimum_to_decode(want, avail) == need
        sub = {c: chunks[c] for c in need}
        got_j, got_t = jc.decode(want, sub, 1024), tc.decode(want, sub, 1024)
        _same(got_j, got_t)
        for c in want:
            np.testing.assert_array_equal(_np(got_t[c]), chunks[c])


def test_clay_encode_decode_repair_match_jax():
    profile = {"plugin": "clay", "k": "8", "m": "4"}
    jc, tc = _jax(profile), _torch(profile)
    L = tc.get_chunk_size(8 * 2048)
    assert L == jc.get_chunk_size(8 * 2048) and L % tc.get_sub_chunk_count() == 0
    data = np.random.default_rng(8).integers(0, 256, (8, L), dtype=np.uint8)
    pj, pt = _np(jc.encode_chunks(data)), _np(tc.encode_chunks(data))
    np.testing.assert_array_equal(pj, pt)
    chunks = {i: data[i] for i in range(8)}
    chunks.update({8 + i: pj[i] for i in range(4)})
    # layered decode, three erasures
    lost = {0, 5, 9}
    have = {c: v for c, v in chunks.items() if c not in lost}
    _same(jc.decode(lost, have, L), tc.decode(lost, have, L))
    # single-shard repair from the d = 11 helpers: same matrix, same bytes
    helpers = tuple(range(1, 12))
    np.testing.assert_array_equal(jc.repair_matrix(0, helpers), tc.repair_matrix(0, helpers))
    assert tc.minimum_to_decode({0}, set(helpers)) == jc.minimum_to_decode({0}, set(helpers))
    have = {c: chunks[c] for c in helpers}
    got = tc.decode({0}, have, L)
    _same(jc.decode({0}, have, L), got)
    np.testing.assert_array_equal(_np(got[0]), data[0])


def test_clay_wide_repair_matches_jax():
    """CLAY(12,4,d=15): q=4, Z=256, a [256, 960] repair matrix, which
    K2 takes in input chunks on the card.  The matrix and the parity
    equal the JAX package's, and the CPU repair rebuilds the chunk."""
    profile = {"plugin": "clay", "k": "12", "m": "4", "d": "15"}
    jc, tc = _jax(profile), _torch(profile)
    helpers = tuple(range(1, 16))
    M = tc.repair_matrix(0, helpers)
    np.testing.assert_array_equal(jc.repair_matrix(0, helpers), M)
    assert M.shape == (256, 960) and kernel_for(*M.shape) == "gf_apply_k2"
    assert k2_layout(*M.shape)[1] < 960
    L = 2 * tc.get_sub_chunk_count()
    data = np.random.default_rng(12).integers(0, 256, (12, L), dtype=np.uint8)
    parity = _np(tc.encode_chunks(data))
    np.testing.assert_array_equal(parity, _np(jc.encode_chunks(data)))
    have = {i: data[i] for i in helpers if i < 12}
    have.update({i: parity[i - 12] for i in helpers if i >= 12})
    got = tc.decode({0}, have, L)
    np.testing.assert_array_equal(_np(got[0]), data[0])


# ---- state carried across: matrices and data on disk ----------------------


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (6, 3), (8, 4), (10, 4), (12, 6)])
def test_matrix_construction_equals_reference(k, m):
    for name in ("vandermonde_coding_matrix", "cauchy_original_coding_matrix",
                 "cauchy_good_coding_matrix"):
        want = getattr(jgf, name)(k, m)
        got = getattr(tgf, name)(k, m)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    coding = jgf.cauchy_good_coding_matrix(k, m).astype(np.uint8)
    np.testing.assert_array_equal(tgf.matrix_to_bitmatrix(coding),
                                  jgf.matrix_to_bitmatrix(coding))
    gen = jgf.systematic_generator(coding)
    np.testing.assert_array_equal(tgf.systematic_generator(coding), gen)
    avail = list(range(m, k + m))
    np.testing.assert_array_equal(tgf.decode_matrix_for(gen, k, avail),
                                  jgf.decode_matrix_for(gen, k, avail))


def test_gf_tables_equal_reference():
    for name in ("GF_EXP", "GF_LOG", "GF_MUL_TABLE", "GF_INV_TABLE"):
        np.testing.assert_array_equal(getattr(tgf, name), getattr(jgf, name))
    assert tgf.GF_POLY == jgf.GF_POLY == 0x11D
    assert sorted(tgf.__all__) == sorted(jgf.__all__)


@pytest.mark.parametrize("profile", [
    {"plugin": "torch", "technique": "cauchy_good", "k": "8", "m": "4"},
    {"plugin": "shec", "k": "6", "m": "3", "c": "2"},
    {"plugin": "clay", "k": "4", "m": "2"},
], ids=lambda p: p["plugin"])
def test_cross_decode_between_packages(profile):
    """Shards written by plugin=jax decode under the port (built from the
    JAX side's arrays), and the port's shards decode under plugin=jax."""
    jprofile = {**profile, "plugin": "jax" if profile["plugin"] == "torch" else profile["plugin"]}
    jc = _jax(jprofile)
    tc = codec_from_arrays(profile, {"coding": jc.coding}, device=CPU)
    n, k = jc.get_chunk_count(), jc.get_data_chunk_count()
    L = tc.get_chunk_size(k * 1024)
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    lost = {1, n - 1}
    for writer, reader in ((jc, tc), (tc, jc)):
        parity = _np(writer.encode_chunks(data))
        chunks = {i: data[i] for i in range(k)}
        chunks.update({k + i: parity[i] for i in range(n - k)})
        have = {c: v for c, v in chunks.items() if c not in lost}
        got = reader.decode(lost, have, L)
        for c in lost:
            np.testing.assert_array_equal(_np(got[c]), chunks[c])


def test_codec_from_arrays_installs_the_given_matrices():
    """A cauchy_good profile carrying reed_sol_van's matrix (and a CLAY
    codec carrying a repair matrix) computes with what it was given."""
    van = _jax({"plugin": "jax", "technique": "reed_sol_van", "k": "4", "m": "2"})
    tc = codec_from_arrays({"technique": "cauchy_good", "k": "4", "m": "2"},
                           {"coding": van.coding}, device=CPU)
    data = np.random.default_rng(4).integers(0, 256, (4, 640), dtype=np.uint8)
    np.testing.assert_array_equal(_np(tc.encode_chunks(data)), _np(van.encode_chunks(data)))
    with pytest.raises(InvalidProfile):
        codec_from_arrays({"k": "4", "m": "2"}, {"coding": van.coding[:1]}, device=CPU)
    with pytest.raises(KeyError):
        codec_from_arrays({"k": "4", "m": "2"}, {"bogus": van.coding}, device=CPU)

    jclay = _jax({"plugin": "clay", "k": "4", "m": "2"})
    helpers = (0, 2, 3, 4, 5)
    M = jclay.repair_matrix(1, helpers)
    tclay = codec_from_arrays({"plugin": "clay", "k": "4", "m": "2"},
                              {"coding": jclay.coding,
                               repair_matrix_name(1, helpers): M}, device=CPU)
    np.testing.assert_array_equal(tclay.repair_matrix(1, helpers), M)
    with pytest.raises(InvalidProfile):
        codec_from_arrays({"plugin": "clay", "k": "4", "m": "2"},
                          {repair_matrix_name(1, helpers): M[:, :3]}, device=CPU)


# ---- device rule ------------------------------------------------------------


def test_default_device_raises_without_a_card(monkeypatch):
    """Entry points default to cuda; with no card they raise rather than
    quietly running on the CPU.  device="cpu" is the explicit opt-in."""
    from ceph_tpu_torch.ec.stripe import StripeInfo
    from ceph_tpu_torch.ops.bitplane import BitplaneCodec, apply_matrix, fused_encode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mat = np.ones((1, 2), np.uint8)
    data = np.zeros((2, 8), np.uint8)
    for call in (
        lambda: TorchRegistry.instance().factory({"k": "2", "m": "1"}),
        lambda: TorchRegistry.instance().factory({"plugin": "clay", "k": "4", "m": "2"}),
        lambda: apply_matrix(mat, data),
        lambda: fused_encode(mat, [data]),
        lambda: BitplaneCodec(mat),
        lambda: StripeInfo(k=2, stripe_unit=4).shard_layout(b"abc"),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    out = apply_matrix(mat, data, device=CPU)
    assert out.device.type == "cpu" and out.shape == (1, 8)
