"""The port's GF(2^8) apply (ceph_tpu_torch/ops/gf_kernels.py) against the
JAX package's Pallas kernel and the numpy reference codec.

On the CPU the wrapper runs the plain PyTorch version, so these hold the
plain version (and the host-side parts of the kernels: split-nibble
tables, the K1/K2 rule, K2's bands) to the reference.  The Pallas kernel
runs in interpret mode, as tests/test_pallas.py runs it, on the cases of
tests/test_pallas.py:31-105.  Bytes must be identical (no tolerance).
The kernels themselves are held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.gf.matrix import (
    cauchy_good_coding_matrix,
    decode_matrix_for,
    systematic_generator,
    vandermonde_coding_matrix,
)
from ceph_tpu.gf.reference_codec import apply_matrix as apply_ref
from ceph_tpu.ops.pallas_gf import apply_matrix_pallas
from ceph_tpu_torch.gf.tables import GF_MUL_TABLE
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import (
    apply_matrix_plain,
    gf_apply,
    k2_layout,
    k2_smem_bytes,
    kernel_for,
    nibble_tables,
)


def _rand(k, L, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (k, L), dtype=np.uint8)


def _port(mat, data):
    return apply_matrix_plain(mat, torch.from_numpy(data)).numpy()


def _three_way(mat, data, **pallas_kw):
    """Port plain version == Pallas (interpret) == numpy reference."""
    mat = np.ascontiguousarray(mat, np.uint8)
    want = apply_ref(mat, data)
    got_jax = np.asarray(apply_matrix_pallas(mat, data, interpret=True, **pallas_kw))
    np.testing.assert_array_equal(got_jax, want)
    np.testing.assert_array_equal(_port(mat, data), want)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 4)])
def test_encode_matches_pallas(k, m):
    coding = cauchy_good_coding_matrix(k, m)
    _three_way(coding, _rand(k, 8192, seed=k * 10 + m), tile=2048)


def test_reed_sol_van_matches_pallas():
    _three_way(vandermonde_coding_matrix(6, 3), _rand(6, 4096, seed=7), tile=1024)


def test_decode_roundtrip_matches_pallas():
    k, m = 8, 4
    coding = np.ascontiguousarray(cauchy_good_coding_matrix(k, m), np.uint8)
    data = _rand(k, 2048, seed=3)
    shards = np.vstack([data, apply_ref(coding, data)])
    avail = [i for i in range(k + m) if i not in {1, 4, 9, 11}][:k]
    dm = decode_matrix_for(systematic_generator(coding), k, avail)
    _three_way(dm, shards[avail], tile=1024)
    np.testing.assert_array_equal(_port(dm.astype(np.uint8), shards[avail]), data)


def test_non_tile_multiple_length_matches_pallas():
    _three_way(cauchy_good_coding_matrix(4, 2), _rand(4, 3000, seed=5), tile=1024)


def test_fat_matrix_matches_blocked_pallas(monkeypatch):
    """CLAY(8,4,d=11)-shaped [64, 176]: K2's matrix on the port side, the
    row-blocked kernel on the JAX side (forced as test_pallas.py does)."""
    monkeypatch.setenv("CEPH_TPU_GF_TILE", "256")
    monkeypatch.setenv("CEPH_TPU_GF_ROWBLOCKS", "4")
    rng = np.random.default_rng(11)
    mat = rng.integers(0, 256, (64, 176), np.uint8)
    assert kernel_for(*mat.shape) == "gf_apply_k2"
    _three_way(mat, rng.integers(0, 256, (176, 512), np.uint8))


def test_ragged_rows_match_blocked_pallas(monkeypatch):
    """13 rows: neither the JAX kernel's row padding nor K2's short band
    may show in the output."""
    monkeypatch.setenv("CEPH_TPU_GF_TILE", "256")
    monkeypatch.setenv("CEPH_TPU_GF_ROWBLOCKS", "4")
    rng = np.random.default_rng(12)
    mat = rng.integers(0, 256, (13, 40), np.uint8)
    assert kernel_for(*mat.shape) == "gf_apply_k2"
    _three_way(mat, rng.integers(0, 256, (40, 300), np.uint8))


# ---- host-side parts of K1/K2 ---------------------------------------------


def test_nibble_tables_multiply_every_byte():
    """lo[b & 15] ^ hi[b >> 4] == c * b for every entry c and byte b."""
    mat = np.arange(256, dtype=np.uint8).reshape(16, 16)
    tab = nibble_tables(mat)
    assert tab.shape == (16, 16, 32) and tab.dtype == np.uint8
    b = np.arange(256)
    prod = tab[:, :, b & 15] ^ tab[:, :, 16 + (b >> 4)]
    np.testing.assert_array_equal(prod, GF_MUL_TABLE[mat[:, :, None], b[None, None, :]])


@pytest.mark.parametrize("shape,want", [
    ((4, 8), "gf_apply_k1"), ((1, 2), "gf_apply_k1"), ((8, 8), "gf_apply_k1"),
    ((3, 6), "gf_apply_k1"), ((16, 32), "gf_apply_k1"), ((17, 2), "gf_apply_k2"),
    ((13, 40), "gf_apply_k2"), ((64, 176), "gf_apply_k2"),
])
def test_kernel_rule(shape, want):
    assert kernel_for(*shape) == want


@pytest.mark.parametrize("rows,n", [
    (1, 1), (13, 40), (64, 176), (2, 400), (256, 960), (300, 5000),
])
def test_k2_bands_fit_shared_memory(rows, n):
    """K2's band and input chunk fit a block's shared memory, the chunks
    are equal and cover n, and n is chunked only when it must be."""
    band, chunk = k2_layout(rows, n)
    assert band == min(rows, gf_kernels.MAX_ROWS)
    assert 1 <= chunk <= n
    assert k2_smem_bytes(chunk, band) <= gf_kernels.SMEM_PER_BLOCK
    chunks = -(-n // chunk)
    assert -(-n // chunks) == chunk
    if chunk < n:
        assert k2_smem_bytes(n, band) > gf_kernels.SMEM_PER_BLOCK
        assert k2_smem_bytes(-(-n // (chunks - 1)), band) > gf_kernels.SMEM_PER_BLOCK


# ---- the wrapper on CPU tensors -------------------------------------------


def test_cpu_segments_are_the_plain_concatenation():
    rng = np.random.default_rng(21)
    mat = rng.integers(0, 256, (4, 8), np.uint8)
    base = torch.from_numpy(rng.integers(0, 256, (8, 5000), np.uint8))
    segs = [base[:, 3:1000], base[:, 1000:1000], base[:, 1200:4999]]
    before = dict(gf_kernels.LAUNCHES)
    out = gf_apply(mat, segs)
    assert gf_kernels.LAUNCHES == before  # no kernel on the CPU
    want = apply_ref(mat, torch.cat(segs, dim=1).numpy())
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("bad", [
    lambda: [torch.zeros((4, 10), dtype=torch.uint8)],          # wrong n
    lambda: [torch.zeros((3, 10), dtype=torch.int32)],          # wrong dtype
    lambda: [torch.zeros((10, 3), dtype=torch.uint8).t()],      # strided columns
    lambda: [torch.zeros(3, dtype=torch.uint8)],                # 1-D
    lambda: [],                                                 # nothing
])
def test_wrapper_rejects_bad_inputs(bad):
    with pytest.raises(ValueError):
        gf_apply(np.ones((2, 3), np.uint8), bad())


def test_prepare_wants_cuda_tensors():
    """Staging a kernel launch for CPU tensors raises; only gf_apply picks
    the plain version, and only for CPU tensors."""
    with pytest.raises(ValueError, match="CUDA"):
        gf_kernels.prepare(np.ones((2, 3), np.uint8), [torch.zeros((3, 8), dtype=torch.uint8)])


def test_plain_version_column_chunks(monkeypatch):
    """The chunked loop gives the same bytes as one pass."""
    rng = np.random.default_rng(31)
    mat = rng.integers(0, 256, (5, 7), np.uint8)
    data = rng.integers(0, 256, (7, 1001), np.uint8)
    monkeypatch.setattr(gf_kernels, "_PLAIN_CHUNK_BYTES", 4 * 8 * 7 * 64)
    np.testing.assert_array_equal(_port(mat, data), apply_ref(mat, data))


@pytest.mark.parametrize("rows,n,L", [(0, 3, 10), (2, 3, 0), (1, 1, 1)])
def test_plain_version_degenerate_shapes(rows, n, L):
    rng = np.random.default_rng(rows + n + L)
    mat = rng.integers(0, 256, (rows, n), np.uint8)
    data = rng.integers(0, 256, (n, L), np.uint8)
    out = _port(mat, data)
    assert out.shape == (rows, L)
    np.testing.assert_array_equal(out, apply_ref(mat, data).reshape(rows, L))
