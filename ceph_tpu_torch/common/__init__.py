"""Runtime helpers of the port (ceph_tpu/common counterparts, as needed)."""
