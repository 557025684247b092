"""The port's GF(2^8) apply (ceph_tpu_torch/ops/gf_kernels.py) against the
JAX package's Pallas kernel and the numpy reference codec.

On the CPU the wrapper runs the plain PyTorch version, so these hold the
plain version (and the host-side parts of the kernels: K1's bit-field
tables, the K1/K2 rule, K2's operand and grid) to the reference.  K2's
arithmetic runs here in its operand's own order and padding.  The Pallas kernel
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
    matrix_to_bitmatrix,
    systematic_generator,
    vandermonde_coding_matrix,
)
from ceph_tpu.gf.reference_codec import apply_matrix as apply_ref
from ceph_tpu.ops.pallas_gf import apply_matrix_pallas
from ceph_tpu_torch.gf.tables import GF_MUL_TABLE
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import (
    apply_matrix_plain,
    device_operand,
    gf_apply,
    k2_layout,
    k2_operand,
    field_tables,
    kernel_for,
    operand_shape,
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
    """K1's tables (``field_tables``, which replaced the split-nibble
    tables): TA[b & 7] ^ TB[(b >> 3) & 7] ^ TC[b >> 6] == c * b for every
    entry c and byte b."""
    mat = np.arange(256, dtype=np.uint8).reshape(16, 16)
    tab = field_tables(mat)
    assert tab.shape == (16, 16, 32) and tab.dtype == np.uint8
    b = np.arange(256)
    prod = tab[:, :, b & 7] ^ tab[:, :, 8 + ((b >> 3) & 7)] ^ tab[:, :, 16 + (b >> 6)]
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
    """K2's row tiles cover the rows and its column tiles a segment's
    length, its operand covers n in whole stages, and one block's two
    stages fit a block's shared memory for any n (the K loop needs no
    input chunks)."""
    L = 65536 + 3
    lay = k2_layout(rows, n, L)
    assert (lay.row_tiles - 1) * gf_kernels.K2_TILE_ROWS < rows <= \
        lay.row_tiles * gf_kernels.K2_TILE_ROWS
    assert (lay.col_tiles - 1) * gf_kernels.K2_TILE_COLS < L <= \
        lay.col_tiles * gf_kernels.K2_TILE_COLS
    assert n <= lay.op_pitch < n + gf_kernels.K2_STAGE_ROWS
    assert lay.op_pitch % gf_kernels.K2_STAGE_ROWS == 0
    assert lay.smem_bytes <= gf_kernels.SMEM_PER_BLOCK
    # shared memory does not cap the blocks an SM holds below the two
    # that K2's registers allow (228 KiB of shared memory an SM)
    assert 2 * lay.smem_bytes <= 228 * 1024
    assert lay.smem_bytes == k2_layout(1, 1, 1).smem_bytes


@pytest.mark.parametrize("rows,n", [(1, 1), (13, 40), (17, 3), (9, 70), (64, 176)])
def test_k2_operand_is_the_permuted_bitmatrix(rows, n):
    """Unpacked, with its row permutation and padding undone, K2's
    operand is the JAX package's GF(2) bitmatrix; the padding is zero."""
    mat = np.random.default_rng(rows * 100 + n).integers(0, 256, (rows, n), np.uint8)
    op = k2_operand(mat)
    lay = k2_layout(rows, n, 1)
    assert op.dtype == np.uint8 and op.shape == (64 * lay.row_tiles, lay.op_pitch)
    bits = np.unpackbits(op, axis=1, bitorder="little")
    plain = np.empty_like(bits)
    for tile in range(lay.row_tiles):
        for b in range(8):
            for i in range(8):  # tile row 8b + i: bit b of output row 8 * tile + i
                plain[8 * (8 * tile + i) + b] = bits[64 * tile + 8 * b + i]
    assert not plain[8 * rows:].any() and not plain[:, 8 * n:].any()
    np.testing.assert_array_equal(plain[:8 * rows, :8 * n], matrix_to_bitmatrix(mat))


def _k2_product(mat, data):
    """K2's arithmetic on the host, in its operand's own order and
    padding: the integer product of the operand's bits with the input's
    bits (k = 8 * j + bit, input rows past n zero), mod 2, and each
    output byte packed from tile rows 8 * b + i as the epilogue does."""
    rows, n = mat.shape
    op = k2_operand(mat)
    pitch = op.shape[1]
    a = np.unpackbits(op, axis=1, bitorder="little").astype(np.int64)
    x = np.zeros((pitch, data.shape[1]), np.uint8)
    x[:n] = data
    b = np.unpackbits(x[:, None, :], axis=1, bitorder="little").reshape(8 * pitch, -1)
    par = ((a @ b.astype(np.int64)) & 1).reshape(-1, 8, 8, data.shape[1])  # [tile, b, i, L]
    out = (par << np.arange(8)[None, :, None, None]).sum(axis=1)
    return out.reshape(-1, data.shape[1])[:rows].astype(np.uint8)


@pytest.mark.parametrize("rows,n,L", [
    (13, 41, 300), (17, 3, 129), (9, 5, 77), (2, 70, 50), (66, 130, 40),
])
def test_k2_product_matches_blocked_pallas(monkeypatch, rows, n, L):
    """Rows not a multiple of 8, n not a multiple of 4: K2's host
    product equals the numpy reference and the JAX row-blocked kernel."""
    monkeypatch.setenv("CEPH_TPU_GF_TILE", "256")
    monkeypatch.setenv("CEPH_TPU_GF_ROWBLOCKS", "4")
    rng = np.random.default_rng(rows + 1000 * n)
    mat = rng.integers(0, 256, (rows, n), np.uint8)
    data = rng.integers(0, 256, (n, L), np.uint8)
    got = _k2_product(mat, data)
    np.testing.assert_array_equal(got, apply_ref(mat, data))
    np.testing.assert_array_equal(
        got, np.asarray(apply_matrix_pallas(mat, data, interpret=True)))


@pytest.mark.parametrize("shape", [(4, 8), (13, 40), (256, 960)])
def test_device_operand_follows_the_rule(shape):
    """The operand the cache holds is the one the picked kernel reads."""
    mat = np.random.default_rng(shape[0]).integers(0, 256, shape, np.uint8)
    op = device_operand(mat)
    assert op.shape == operand_shape(*shape)
    want = field_tables(mat) if kernel_for(*shape) == "gf_apply_k1" else k2_operand(mat)
    np.testing.assert_array_equal(op, want)


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
