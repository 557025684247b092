"""The OSD layer's port (ceph_tpu/osd counterparts, as ported).

The OSDMap's placement math: OSDMap::pg_to_up_acting_osds and
OSDMap::calc_pg_upmaps, with the CRUSH descent of a whole pool batched on
the card (``OSDMap.map_pool`` → crush_do_rule_batch → K3); the PG's log,
past intervals and state; the wire messages; and the OSD's data plane:
the write batcher's fused flush, the read batcher's gather and grouped
decode, and the primary's read cache.  This package exports what the
reference's does.
"""
from .osdmap import (
    PG_POOL_ERASURE,
    PG_POOL_REPLICATED,
    OSDMap,
    PGPool,
    ceph_stable_mod,
    pg_num_mask,
)
from .balancer import calc_pg_upmaps
from .placement import (
    cluster_report,
    diff_mappings,
    pool_pg_counts,
    pool_skew,
    rule_osd_info,
)

__all__ = [
    "OSDMap",
    "PGPool",
    "PG_POOL_ERASURE",
    "PG_POOL_REPLICATED",
    "calc_pg_upmaps",
    "ceph_stable_mod",  # noqa: CL12 — exported helper name, not a series
    "cluster_report",
    "diff_mappings",
    "pg_num_mask",
    "pool_pg_counts",
    "pool_skew",
    "rule_osd_info",
]
