"""K1's host side and arithmetic (ceph_tpu_torch/ops/gf_kernels.py,
csrc/gf_apply.cu::gf_apply_k1) on the CPU.

K1 looks a GF(2^8) product c*b up in three bit-field tables,
c*b = TA[b & 7] ^ TB[(b >> 3) & 7] ^ TC[b >> 6], four bytes at a time
with one __byte_perm a field.  A numpy model of that word arithmetic
(the perm with its sign-replicating selector bit, the selector packing
by a multiply that leaves the output bytes swapped in pairs, the three
lookups of ``field_tables``, the swap back) is held to GF_MUL_TABLE over every
(c, b) pair in every byte lane and at random words, and, run over whole
matrices in K1's own order, to the numpy reference codec and the JAX
package's Pallas kernel in interpret mode.  ``k1_layout`` is checked at
the main path's launch shapes, and the constants shared with the CUDA
source are read from it.  Bytes must be identical (no tolerance).  The
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu.gf.matrix import cauchy_good_coding_matrix, decode_matrix_for, systematic_generator
from ceph_tpu.gf.reference_codec import apply_matrix as apply_ref
from ceph_tpu.ops.pallas_gf import apply_matrix_pallas
from ceph_tpu_torch.gf.tables import GF_MUL_TABLE
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import (
    K1_PARAM_SEGS,
    K1_RING,
    K1_TILES,
    TABLE_BYTES_PER_ENTRY,
    field_tables,
    k1_layout,
)

CSRC = Path(gf_kernels.__file__).resolve().parents[1] / "csrc" / "gf_apply.cu"
H100_SMS = 132


# ---- a numpy model of the kernel's word arithmetic ------------------------


def byte_perm(x, y, s):
    """prmt.b32 in its default mode (``__byte_perm``), elementwise on
    uint32 arrays: byte k of the result is byte (s >> 4k) & 7 of y:x, or
    that byte's sign replicated when bit 3 of the nibble is set."""
    x, y, s = (np.asarray(a, dtype=np.uint64) for a in (x, y, s))
    both = y << np.uint64(32) | x
    out = np.zeros(np.broadcast(x, y, s).shape, dtype=np.uint64)
    for k in range(4):
        nib = (s >> np.uint64(4 * k)) & np.uint64(15)
        v = (both >> (np.uint64(8) * (nib & np.uint64(7)))) & np.uint64(0xFF)
        v = np.where(nib & np.uint64(8), np.where(v & np.uint64(0x80), 0xFF, 0), v)
        out |= v.astype(np.uint64) << np.uint64(8 * k)
    return out.astype(np.uint32)


def selector(y):
    """csrc ``selector``: bytes y0..y3 (each < 8) -> nibbles y1, y0, y3, y2
    (y * 0x1001 mod 2^32, bytes 1 and 3 gathered)."""
    y = np.asarray(y, dtype=np.uint32)
    return byte_perm(y * np.uint32(0x1001), 0, 0x4431)


def unswap(acc):
    """csrc: each accumulator's byte pairs swapped back before its store."""
    return byte_perm(acc, 0, 0x2301)


def split_fields(x):
    """csrc ``split_fields``: the three field selectors of a word."""
    x = np.asarray(x, dtype=np.uint32)
    return (selector(x & np.uint32(0x07070707)),
            selector((x >> np.uint32(3)) & np.uint32(0x07070707)),
            selector((x >> np.uint32(6)) & np.uint32(0x03030303)))


def entry_words(tables):
    """The five table words of each entry of ``field_tables`` as K1 reads
    them from shared memory: TA in .x .y, TB in .z .w, TC in the next .x."""
    w = np.ascontiguousarray(tables).view("<u4")
    return w[..., 0], w[..., 1], w[..., 2], w[..., 3], w[..., 4]


def lookup(words, x):
    """csrc ``lookup`` for one entry: c*x for the four bytes of word x,
    its bytes swapped in pairs (1 0 3 2)."""
    ta0, ta1, tb0, tb1, tc = words
    sa, sb, sc = split_fields(x)
    return byte_perm(ta0, ta1, sa) ^ byte_perm(tb0, tb1, sb) ^ byte_perm(tc, tc, sc)


def k1_product(mat, data):
    """K1's arithmetic over a whole [rows, n] x [n, L] apply on the host,
    in its own order: the input as little-endian words (the tail padded
    with zeros, as the kernel's masked loads read it), each output row
    the XOR over j of the lookups of entry (i, j)."""
    rows, n = mat.shape
    L = data.shape[1]
    words = np.zeros((n, -(-L // 4) * 4), dtype=np.uint8)
    words[:, :L] = data
    x = words.view("<u4")
    tw = entry_words(field_tables(mat))
    acc = np.zeros((rows, x.shape[1]), dtype=np.uint32)
    for i in range(rows):
        for j in range(n):
            acc[i] ^= lookup(tuple(w[i, j] for w in tw), x[j])
    return unswap(acc).view(np.uint8)[:, :L]


def test_byte_perm_model_picks_and_replicates():
    x, y = 0x83_02_81_00, 0x07_86_05_04
    assert byte_perm(x, y, 0x7654) == y
    assert byte_perm(x, y, 0x3210) == x
    assert byte_perm(x, y, 0x0001) == 0x00_00_00_81
    assert byte_perm(x, y, 0x4420) == 0x04_04_02_00
    assert byte_perm(x, y, 0x4431) == 0x04_04_83_81
    assert byte_perm(x, 0, 0x2301) == 0x02_83_00_81
    # bit 3 of a nibble: 0x81 and 0x83 have their sign set, 0x02 not
    assert byte_perm(x, y, 0xAB39) == 0x00_FF_83_FF


def test_selector_packs_nibbles():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 8, (4096, 4)).astype(np.uint32)
    packed = y[:, 0] | y[:, 1] << 8 | y[:, 2] << 16 | y[:, 3] << 24
    want = y[:, 1] | y[:, 0] << 4 | y[:, 3] << 8 | y[:, 2] << 12
    np.testing.assert_array_equal(selector(packed), want)


@pytest.mark.parametrize("lane", [0, 1, 2, 3])
def test_word_arithmetic_every_pair_in_every_lane(lane):
    """c*b in byte `lane` of a word for all 256 x 256 (c, b), the other
    three bytes random (and checked too); no selector nibble has bit 3."""
    rng = np.random.default_rng(lane)
    tw = entry_words(field_tables(np.arange(256, dtype=np.uint8)[:, None]))
    b = np.arange(256, dtype=np.uint32)
    for c in range(256):
        other = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
        x = (other & ~np.uint32(0xFF << 8 * lane)) | b << np.uint32(8 * lane)
        for sel in split_fields(x):
            assert not (sel & np.uint32(0xFFFF8888)).any()
        got = unswap(lookup(tuple(w[c, 0] for w in tw), x)).view(np.uint8).reshape(256, 4)
        np.testing.assert_array_equal(
            got, GF_MUL_TABLE[c][x.view(np.uint8).reshape(256, 4)])


def test_word_arithmetic_random_words():
    """65,536 random (c, word) pairs, all four bytes."""
    rng = np.random.default_rng(7)
    c = rng.integers(0, 256, 1 << 16)
    x = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    tw = entry_words(field_tables(np.arange(256, dtype=np.uint8)[:, None]))
    got = unswap(lookup(tuple(w[c, 0] for w in tw), x)).view(np.uint8).reshape(-1, 4)
    np.testing.assert_array_equal(
        got, GF_MUL_TABLE[c[:, None], x.view(np.uint8).reshape(-1, 4)])


@pytest.mark.parametrize("rows,n,L", [(4, 8, 3000), (8, 8, 1029), (1, 2, 17), (16, 32, 64),
                                      (4, 128, 33), (13, 5, 4101)])
def test_k1_product_matches_pallas(rows, n, L):
    """K1's word arithmetic over a whole apply equals the numpy reference
    and the JAX package's Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(rows * 1000 + n)
    mat = rng.integers(0, 256, (rows, n), np.uint8)
    data = rng.integers(0, 256, (n, L), np.uint8)
    got = k1_product(mat, data)
    np.testing.assert_array_equal(got, apply_ref(mat, data))
    np.testing.assert_array_equal(
        got, np.asarray(apply_matrix_pallas(mat, data, interpret=True, tile=1024)))


def test_k1_product_rs84_decode():
    """RS(8,4) cauchy_good with shards 1, 4, 9, 11 lost: K1's arithmetic
    on the decode matrix gives the data back."""
    coding = np.ascontiguousarray(cauchy_good_coding_matrix(8, 4), np.uint8)
    data = np.random.default_rng(3).integers(0, 256, (8, 1000), np.uint8)
    shards = np.vstack([data, k1_product(coding, data)])
    avail = [0, 2, 3, 5, 6, 7, 8, 10]
    dm = decode_matrix_for(systematic_generator(coding), 8, avail).astype(np.uint8)
    np.testing.assert_array_equal(k1_product(dm, shards[avail]), data)


# ---- field_tables ----------------------------------------------------------


def test_field_tables_entry_by_entry():
    """Each entry: TA[x] = c*x, TB[x] = c*(x << 3), TC[x] = c*(x << 6),
    then zeros, 32 bytes."""
    mat = np.random.default_rng(5).integers(0, 256, (7, 11), np.uint8)
    tab = field_tables(mat)
    assert tab.shape == (7, 11, TABLE_BYTES_PER_ENTRY) and tab.dtype == np.uint8
    assert tab.flags.c_contiguous
    for i in range(7):
        for j in range(11):
            c = mat[i, j]
            for x in range(8):
                assert tab[i, j, x] == GF_MUL_TABLE[c, x]
                assert tab[i, j, 8 + x] == GF_MUL_TABLE[c, x << 3]
            for x in range(4):
                assert tab[i, j, 16 + x] == GF_MUL_TABLE[c, x << 6]
            assert not tab[i, j, 20:].any()


# ---- k1_layout ------------------------------------------------------------


def test_k1_layout_at_the_main_path_shapes():
    # a 4 MiB object's [8, 524288] stripe (cluster write and degraded read)
    lay = k1_layout(524288, 1, H100_SMS)
    assert (lay.threads, lay.vecs, lay.tile_cols, lay.col_tiles) == (128, 1, 2048, 256)
    # the write batcher's packed flush and the EC path's 256 stripes: the ceiling
    flush = k1_layout(256 * 131072, 1, H100_SMS)
    assert (flush.tile_cols, flush.col_tiles) == (8192, 4096)
    ec = k1_layout(131072, 256, H100_SMS)
    assert (ec.tile_cols, ec.col_tiles * 256) == (8192, 4096)


@pytest.mark.parametrize("sms", [1, 4, 132])
def test_k1_layout_largest_tile_with_two_blocks_an_sm(sms):
    for L in (1, 100, 2047, 2048, 2049, 65537, 524288, 1 << 22, 3 << 21):
        for nseg in (1, 3, 256):
            lay = k1_layout(L, nseg, sms)
            assert (lay.threads, lay.vecs) in K1_TILES
            larger = K1_TILES[:K1_TILES.index((lay.threads, lay.vecs))]
            for threads, vecs in larger:  # each larger tile gives too few blocks
                assert -(-L // (16 * threads * vecs)) * nseg < 2 * sms
            if (lay.threads, lay.vecs) != K1_TILES[-1]:
                assert lay.col_tiles * nseg >= 2 * sms


@pytest.mark.parametrize("L", [1, 15, 16, 17, 2047, 2048, 2049, 3000, 4095, 4097, 8191, 8193,
                               131071, 524289, 33554431])
def test_k1_layout_covers_ragged_lengths(L):
    """The blocks cover the longest segment exactly: the last tile holds
    its end, none lies past it."""
    for nseg in (1, 2, 300):
        lay = k1_layout(L, nseg, H100_SMS)
        assert (lay.col_tiles - 1) * lay.tile_cols < L <= lay.col_tiles * lay.tile_cols


# ---- constants shared with the CUDA source ---------------------------------


def _csrc_constant(name):
    m = re.search(rf"constexpr int {name} = ([0-9* ]+);", CSRC.read_text())
    assert m, f"{name} not in {CSRC.name}"
    return eval(m.group(1))


def test_constants_match_the_cuda_source():
    assert _csrc_constant("K1_RING") == K1_RING
    assert _csrc_constant("K1_PARAM_SEGS") == K1_PARAM_SEGS
    assert _csrc_constant("K1_MAX_TABLE_BYTES") == gf_kernels.K1_MAX_TABLE_BYTES
    assert max(t for t, _ in K1_TILES) == _csrc_constant("K1_MAX_THREADS")
    assert max(v for _, v in K1_TILES) == _csrc_constant("K1_MAX_VECS")
    assert min(t for t, _ in K1_TILES) % 32 == 0
    # K1's parameters: six scalars and pointers (48 bytes) and the
    # by-value descriptors (32 bytes each) within 4 KiB
    assert 48 + 32 * K1_PARAM_SEGS <= 4096
    # the largest K1 matrix's tables fit the 48 KiB a launch gets without
    # the dynamic shared-memory attribute
    assert gf_kernels.K1_MAX_TABLE_BYTES <= 48 * 1024
