"""ceph_tpu_torch.mon — the control plane's port (reference: ceph_tpu/mon,
src/mon).

Monitors hold the authoritative cluster maps, replicated across the quorum
by single-decree Paxos over the MonitorDBStore (here: LogKV/MemKV).  The
OSDMonitor is the OSDMap authority: EC profile validation (instantiating
the codec through the erasure-code registry on the monitor's device, as
`osd erasure-code-profile set` vets `plugin=torch`), pool creation with
CRUSH rule synthesis, failure-report corroboration → down, and the
down→out timer.  MonClient is the daemon/client session: commands, map
subscriptions, boot.
"""
from .mon_client import MonClient
from .monitor import MonMap, Monitor

__all__ = ["MonClient", "MonMap", "Monitor"]
