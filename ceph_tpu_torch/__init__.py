"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu.

A second package beside the JAX reference (ceph_tpu/), laid out like it so
each module's counterpart is easy to find.  It imports torch and numpy and
nothing of jax or ceph_tpu.  Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``; without a card it raises rather than
quietly running on the host.

Ported so far: gf/ (tables, matrices, numpy referee), ops/ (the GF(2^8)
matrix apply: two hand-written CUDA kernels in csrc/gf_apply.cu and their
plain PyTorch version; the straw2 draw K3 and the crush_ln probe in
csrc/crush_straw2.cu), ec/ (interface, registry, stripe math, the RS,
SHEC and CLAY plugins), crush/ (map model, builder, scalar and batched
mappers, CrushWrapper), tools/crushtool, and the OSD's data plane: osd/
(the write and read batchers, the read cache) on ops/device_pool.py,
ops/pipeline.py and the runtime in common/ (config and options,
context, failpoints, throttle, perf counters, tracer, kernel
telemetry); the cluster substrate (common/buffer and crc32c, the
native_oracle loader, auth/, compressor/, store/, msg/ and the wire
messages of mon/, mgr/ and osd/, the PG log and past intervals); and
the OSDMap (osd/osdmap.py, whose map_pool maps a pool on the card
through K3), the placement core, the upmap balancer and
tools/osdmaptool.
"""
from .common.device import resolve_device

__all__ = ["resolve_device"]
