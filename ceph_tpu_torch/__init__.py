"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu's erasure-code data plane.

A second package beside the JAX reference (ceph_tpu/), laid out like it so
each module's counterpart is easy to find.  It imports torch and numpy and
nothing of jax or ceph_tpu.  Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``; without a card it raises rather than
quietly running on the host.

Ported so far: gf/ (tables, matrices, numpy referee), ops/ (the GF(2^8)
matrix apply: two hand-written CUDA kernels in csrc/gf_apply.cu and their
plain PyTorch version), ec/ (interface, registry, stripe math, the RS,
SHEC and CLAY plugins).
"""
from .common.device import resolve_device

__all__ = ["resolve_device"]
