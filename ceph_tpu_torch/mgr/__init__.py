"""ceph_tpu_torch.mgr — the manager plane's port (reference: ceph_tpu/mgr).

Ported so far: the mgr's wire message types (mgr/messages.py).  MgrDaemon,
MgrModule and MODULE_REGISTRY, which the reference package's __init__
exports, come with the mgr's own slice.
"""
