"""In-process multi-daemon clusters (counterpart of ceph_tpu/qa;
reference: src/vstart.sh + qa/standalone/ceph-helpers.sh)."""
from .vstart import LocalCluster

__all__ = ["LocalCluster"]
