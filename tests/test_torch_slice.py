"""The port's slice end to end at small size, against the JAX package: a
few 64 KiB objects are sharded (StripeInfo), written in one fused encode,
lose four shards each, are decoded through the registry codec and
unsharded — in both packages, byte for byte.  This is chip_smoke.py's
RS(8,4) phase at test size, on the CPU."""
import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.ec.stripe import StripeInfo as JaxStripeInfo
from ceph_tpu.ops.bitplane import fused_encode_async
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry as TorchRegistry
from ceph_tpu_torch.ec.stripe import StripeInfo
from ceph_tpu_torch.ops.bitplane import fused_encode

PROFILE = {"technique": "cauchy_good", "k": "8", "m": "4"}
LOST = (1, 4, 9, 11)


@pytest.mark.parametrize("sizes", [(65536,) * 4, (65536, 1000, 40000)],
                         ids=["equal", "ragged"])
def test_write_and_degraded_read_match_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    objects = [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]
    jc = JaxRegistry.instance().factory({**PROFILE, "plugin": "jax"})
    tc = TorchRegistry.instance().factory({**PROFILE, "plugin": "torch"}, device="cpu")
    jsi, tsi = JaxStripeInfo(k=8, stripe_unit=4096), StripeInfo(k=8, stripe_unit=4096)

    j_stripes = [jsi.shard_layout(o) for o in objects]
    t_stripes = [tsi.shard_layout(o, device="cpu") for o in objects]
    for a, b in zip(j_stripes, t_stripes):
        np.testing.assert_array_equal(a, b.numpy())

    # one fused flush per package: [4, sum of shard lengths]
    j_par = np.asarray(fused_encode_async(jc.coding, j_stripes))
    t_par = tc.bitplane.encode_many(t_stripes)
    assert t_par.shape == (4, sum(s.shape[1] for s in t_stripes))
    np.testing.assert_array_equal(j_par[:, : t_par.shape[1]], t_par.numpy())
    np.testing.assert_array_equal(
        t_par.numpy(), fused_encode(tc.coding, t_stripes, device="cpu").numpy())

    # per object: erase the lost shards, decode the data, unshard
    col = 0
    for obj, js, ts in zip(objects, j_stripes, t_stripes):
        S = ts.shape[1]
        shards = np.vstack([js, j_par[:, col:col + S]])
        col += S
        have = {c: shards[c] for c in range(12) if c not in LOST}
        need = tc.minimum_to_decode(set(range(8)), set(have))
        assert need == jc.minimum_to_decode(set(range(8)), set(have))
        got_j = jc.decode(set(range(8)), {c: have[c] for c in need}, S)
        got_t = tc.decode(set(range(8)), {c: have[c] for c in need}, S)
        data_j = np.stack([np.asarray(got_j[i]) for i in range(8)])
        data_t = torch.stack([got_t[i] for i in range(8)])
        np.testing.assert_array_equal(data_j, data_t.numpy())
        assert jsi.unshard(data_j, len(obj)) == obj
        assert tsi.unshard(data_t, len(obj)).numpy().tobytes() == obj
        # recovery: rebuild the two lost parity shards from the survivors
        avail = sorted(need)
        rebuilt = tc.bitplane.reconstruct(avail, np.stack([have[c] for c in avail]), [9, 11])
        np.testing.assert_array_equal(rebuilt.numpy(), shards[[9, 11]])
