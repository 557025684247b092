"""Stripe math — ECUtil::stripe_info_t (counterpart of ceph_tpu/ec/stripe.py).

Reference: src/osd/ECUtil.h :: stripe_info_t — an object is laid out in
stripes of stripe_width = k * chunk_size bytes; chunk i of every stripe
lands on shard i.  So shard j of an object is the concatenation of chunk j
of every stripe, and a whole-object encode is ONE [k, object_size/k]
apply with the stripe axis folded into the shard length.  The layout runs
on the device: bytes go in and come out as uint8 tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..common.device import as_bytes_tensor, resolve_device


@dataclass(frozen=True)
class StripeInfo:
    """stripe_unit = chunk bytes per stripe; k = data chunks per stripe."""

    k: int
    stripe_unit: int

    @property
    def stripe_width(self) -> int:
        return self.k * self.stripe_unit

    def object_stripes(self, object_size: int) -> int:
        """Number of stripes covering an object (last may be padded)."""
        return -(-object_size // self.stripe_width)

    def shard_size(self, object_size: int) -> int:
        return self.object_stripes(object_size) * self.stripe_unit

    def shard_layout(self, data, device=None) -> torch.Tensor:
        """Object bytes (bytes, numpy or a 1-D uint8 tensor) -> [k,
        shard_size] shard tensor on `device`, zero padded: chunk i of each
        stripe goes to shard i, in one reshape/transpose pass."""
        dev = resolve_device(device)
        raw = as_bytes_tensor(data, dev).reshape(-1)
        size = raw.numel()
        n_stripes = max(1, self.object_stripes(size))
        buf = torch.zeros(n_stripes * self.stripe_width, dtype=torch.uint8, device=dev)
        buf[:size] = raw
        # [stripes, k, unit] -> [k, stripes, unit] -> [k, shard]
        arr = buf.reshape(n_stripes, self.k, self.stripe_unit)
        return arr.permute(1, 0, 2).reshape(self.k, -1)

    def unshard(self, shards: torch.Tensor, object_size: int) -> torch.Tensor:
        """[k, shard_size] -> the object's bytes, a 1-D uint8 tensor on the
        shards' device."""
        k, shard_size = shards.shape
        if k != self.k:
            raise ValueError(f"expected {self.k} shards, got {k}")
        n_stripes = shard_size // self.stripe_unit
        arr = shards.reshape(k, n_stripes, self.stripe_unit).permute(1, 0, 2)
        return arr.reshape(-1)[:object_size]
