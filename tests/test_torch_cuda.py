"""The port's CUDA kernels on the card: K1 and K2 against the plain
PyTorch version, byte for byte, at edge-case shapes (ragged lengths,
unaligned and strided rows, several segments in one launch, short last
K2 band, K2 taking its inputs in chunks).  Marked ``cuda``: each test skips without a card.  On a GPU
machine (the JAX package is not needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from ceph_tpu_torch.gf.matrix import cauchy_good_coding_matrix
from ceph_tpu_torch.gf.reference_codec import apply_matrix as apply_ref
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import apply_matrix_plain, gf_apply, kernel_for

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("rows,n,L", [
    (4, 8, 3000), (1, 2, 9001), (8, 8, 4096), (13, 5, 4101), (16, 32, 777),
    (64, 176, 1030), (13, 40, 300), (17, 3, 5000), (2, 400, 129),
    (16, 228, 3001), (5, 2000, 1031), (256, 960, 1030),
])
def test_kernel_matches_plain(cuda, rows, n, L):
    rng = np.random.default_rng(rows * 1000 + n)
    mat = _rand(rng, (rows, n))
    x = torch.from_numpy(_rand(rng, (n, L))).to(cuda)
    before = dict(gf_kernels.LAUNCHES)
    out = gf_apply(mat, [x])
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES[kernel_for(rows, n)] == before[kernel_for(rows, n)] + 1
    assert torch.equal(out, apply_matrix_plain(mat, x))
    np.testing.assert_array_equal(out.cpu().numpy(), apply_ref(mat, x.cpu().numpy()))


@pytest.mark.parametrize("rows,n", [(4, 8), (64, 176), (256, 960)])
def test_segments_strided_and_unaligned(cuda, rows, n):
    """One launch over views at odd offsets and row strides, with ragged
    and empty segments, equals the plain apply of their concatenation."""
    rng = np.random.default_rng(rows + n)
    mat = _rand(rng, (rows, n))
    base = torch.from_numpy(_rand(rng, (n, 20011))).to(cuda)
    segs = [base[:, 1:4097], base[:, 4100:4100], base[:, 5003:9010],
            base[:, 9999:20011], base[:, 3:6]]
    out = gf_apply(mat, segs)
    want = apply_matrix_plain(mat, torch.cat(segs, dim=1).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_fused_encode_one_launch(cuda):
    from ceph_tpu_torch.ops.bitplane import fused_encode

    rng = np.random.default_rng(5)
    coding = cauchy_good_coding_matrix(8, 4).astype(np.uint8)
    stripes = [torch.from_numpy(_rand(rng, (8, L))).to(cuda) for L in (4096, 64, 12345)]
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    par = fused_encode(coding, stripes)
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + 1
    want = np.concatenate([apply_ref(coding, s.cpu().numpy()) for s in stripes], axis=1)
    np.testing.assert_array_equal(par.cpu().numpy(), want)


def test_clay_wide_repair(cuda):
    """CLAY(12,4,d=15) repair: a [256, 960] matrix, K2 in input chunks."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    clay = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "clay", "k": "12", "m": "4", "d": "15"}, device=cuda)
    L = 65 * clay.get_sub_chunk_count()  # sub-chunks of 65 bytes: unaligned words
    data = torch.from_numpy(_rand(np.random.default_rng(15), (12, L))).to(cuda)
    parity = clay.encode_chunks(data)
    have = {i: data[i] for i in range(1, 12)}
    have.update({12 + i: parity[i] for i in range(4)})
    before = gf_kernels.LAUNCHES["gf_apply_k2"]
    got = clay.decode({0}, have, L)
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES["gf_apply_k2"] == before + 1
    assert torch.equal(got[0], data[0])


def test_bad_inputs_raise(cuda):
    mat = np.ones((2, 3), np.uint8)
    with pytest.raises(ValueError):
        gf_apply(mat, [torch.zeros((4, 10), dtype=torch.uint8, device=cuda)])
    with pytest.raises(ValueError):
        gf_apply(mat, [torch.zeros((3, 10), dtype=torch.int32, device=cuda)])
    with pytest.raises(ValueError):
        gf_apply(mat, [torch.zeros((10, 3), dtype=torch.uint8, device=cuda).t()])


def test_prepared_launch_repeats(cuda):
    """A staged launch (what chip_smoke.py times) relaunches into the same
    output, counts every launch and gives the wrapper's bytes."""
    rng = np.random.default_rng(9)
    mat = _rand(rng, (4, 8))
    segs = [torch.from_numpy(_rand(rng, (8, 5000))).to(cuda) for _ in range(3)]
    launch = gf_kernels.prepare(mat, segs)
    before = gf_kernels.LAUNCHES["gf_apply_k1"]
    first = launch().clone()
    second = launch()
    torch.cuda.synchronize()
    assert gf_kernels.LAUNCHES["gf_apply_k1"] == before + 2
    assert torch.equal(first, second) and torch.equal(second, gf_apply(mat, segs))
