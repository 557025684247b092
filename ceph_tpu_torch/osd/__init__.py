"""The OSD's data plane (ceph_tpu/osd counterparts, as ported): the write
batcher's fused flush, the read batcher's gather and grouped decode, and
the primary's read cache."""
