"""ceph_tpu_torch.mon — the control plane's port (reference: ceph_tpu/mon).

Ported so far: the monitor's wire message types (mon/messages.py).  The
reference package's __init__ also exports MonClient, MonMap and Monitor;
they come with the monitor's own slice, so importing this package pulls
in nothing unported (osd/messages.py and mgr/messages.py import
``mon.messages._JsonMessage``).
"""
