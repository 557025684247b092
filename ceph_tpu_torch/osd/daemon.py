"""OSD daemon — the EC data plane tied end-to-end (reference: src/osd/OSD.cc
boot/dispatch, src/osd/PrimaryLogPG.cc op execution, src/osd/ECBackend.cc
encode/fan-out/reconstruct/recover; SURVEY.md §3.1-3.2 call stacks).

One OSD process = messenger (lossless peer policy) + MonClient session +
ObjectStore + per-PG state.  The data model is the reference's at object
granularity:

- write: primary encodes the object through the pool's EC profile codec
  (ErasureCodePluginRegistry — the device path), ships one chunk per shard as
  MECSubOpWrite (each carrying the pg_log entry), commits its own shard,
  acks the client at >= min_size shard commits after an UPFRONT min_size
  reachability gate (ECBackend::submit_transaction shape + PrimaryLogPG's
  min_size refusal).
- ranged write / append: partial-stripe RMW as a parity-delta update —
  touched data shards get spliced segments, parity shards GF-XOR one
  matrix-apply's worth of delta over just the touched column window
  (reference: ECTransaction::generate_transactions, in the optimized-EC
  delta formulation).  Safety comes from per-object version stamps
  (object_info_t analog): stale-generation shards refuse the delta and
  are rebuilt by recovery; resends are answered by the per-PG reqid dup
  cache (pg_log dup entries analog).
- read: primary gathers k chunks (local + MECSubOpRead), reconstructs
  through minimum_to_decode/decode when shards are gone
  (objects_read_and_reconstruct), reassembles bytes.
- recovery: on map change the primary runs peering-lite — MPGQuery each
  acting shard, delta-push objects the peer's pg_log version misses
  (PGLog.missing_since), or full-backfill a shard whose log is too old
  (recover_object / backfill split, §5.4).

Scope notes vs the reference: scalar versions rather than eversion_t, and
peering without the boost::statechart machine — the invariants these
protect (log/data atomicity, min_size-gated acks, delta-vs-backfill
choice, no mixed-generation decodes, missing_loc-style stray-source
recovery) are kept.
"""
from __future__ import annotations


import json
import threading
import time
from collections import OrderedDict

from ..common.device import resolve_device
from ..common.failpoint import failpoint, registry as fp_registry
from ..common.io_accounting import IOAccounting
from ..common.kernel_telemetry import (
    DEVICE_PERF,
    SENTINEL,
    TELEMETRY,
    SentinelPolicy,
)
from ..common.lockdep import make_lock
from ..common.perf_counters import PerfCountersBuilder
from ..common.recovery_accounting import RecoveryAccounting
from ..common.tracer import TRACER, op_trace, sampled_ctx, trace_now
from ..common.tracked_op import OpTracker
from ..ec.registry import ErasureCodePluginRegistry
from ..mon.mon_client import MonClient
from ..msg import Dispatcher, Messenger
from ..msg.messenger import POLICY_LOSSLESS_PEER
from ..osd.osdmap import OSDMap
from ..store.memstore import MemStore
from ..store.object_store import NotFound, Transaction
from .messages import (
    MECSubOpRead,
    MWatchNotifyAck,
    MECSubOpReadReply,
    MECSubOpWrite,
    MECSubOpWriteReply,
    MOSDOp,
    MOSDOpReply,
    MOSDPingMsg,
    MPGClean,
    MPGNotify,
    MPGPull,
    MPGPullReply,
    MPGQuery,
    MScrubShard,
    MScrubShardReply,
)
from ..mgr.messages import MQoSSettings
from .pg_log import LogEntry, PGLog
from .scheduler import MClockScheduler, QoSParams, SchedulerPerf
from .ec_backend import ECBackendMixin
from .object_ops import ObjectOpsMixin
from .pg import (  # noqa: F401  (re-exported: long-standing import surface)
    CLONE_SEP,
    MUTATING_OPS,
    PGState,
    _current_generation,
)
from .primary_ops import PrimaryOpsMixin
from .recovery import RecoveryMixin
from .replicated_backend import ReplicatedBackendMixin
from .scrub import ScrubMixin
from .read_batcher import ReadBatcher
from .read_cache import ReadCache
from .split_migration import SplitMigrationMixin
from .subops import SubOpsMixin
from .tiering import TieringMixin
from .write_batcher import WriteBatcher


#: Placements shared by every OSD of the process, keyed by what a
#: placement depends on: the map's JSON less its epoch, addresses,
#: profiles and auth generations.  The OSDs of a LocalCluster decode the
#: same epochs, and most epochs (a boot, a profile, a pool flag) move no
#: PG; each recomputing the scalar CRUSH descent of every PG it holds,
#: for the old map and the new, would hold the interpreter lock for
#: seconds an epoch and starve a monitor's handshakes.  A placement is a
#: pure function of its key, so sharing one changes no result.
_PLACEMENTS: "OrderedDict[str, _Placements]" = OrderedDict()
_PLACEMENTS_MAX = 64
_PLACEMENTS_LOCK = make_lock("osd::placements_index")


class _Placements(dict):
    """{(pool, ps): (up, up_primary, acting, acting_primary)} of one set
    of placement inputs, with the lock that computes each PG once: the
    OSDs meet a new pool's PGs together, and each computing them would
    cost as much as not sharing."""

    def __init__(self) -> None:
        super().__init__()
        self.lock = make_lock("osd::placements")


def _placements_of(m: OSDMap) -> _Placements:
    d = m.to_json()
    for k in ("epoch", "osd_addrs", "ec_profiles", "auth_gens"):
        d.pop(k, None)
    key = json.dumps(d, sort_keys=True, default=str)
    with _PLACEMENTS_LOCK:
        got = _PLACEMENTS.get(key)
        if got is None:
            got = _PLACEMENTS[key] = _Placements()
            if len(_PLACEMENTS) > _PLACEMENTS_MAX:
                _PLACEMENTS.popitem(last=False)
        else:
            _PLACEMENTS.move_to_end(key)
    return got


def _placed(memo: tuple, pool_id: int, ps: int) -> tuple:
    """A PG's placement from a (map, placements) memo, computed once."""
    got = memo[1].get((pool_id, ps))
    if got is None:
        with memo[1].lock:
            got = memo[1].get((pool_id, ps))
            if got is None:
                up, up_p, acting, acting_p = memo[0].pg_to_up_acting_osds(pool_id, ps)
                got = memo[1][(pool_id, ps)] = (
                    tuple(up), up_p, tuple(acting), acting_p)
    return got


class OSD(
    Dispatcher,
    PrimaryOpsMixin,
    ECBackendMixin,
    ObjectOpsMixin,
    ReplicatedBackendMixin,
    TieringMixin,
    SubOpsMixin,
    ScrubMixin,
    SplitMigrationMixin,
    RecoveryMixin,
):
    """reference: src/osd/OSD.{h,cc} (boot, dispatch, heartbeats) +
    PrimaryLogPG/ECBackend op execution, collapsed to one class."""

    def __init__(self, cct, osd_id: int, mon_addrs, store=None):
        self.cct = cct
        self.id = osd_id
        self.whoami = f"osd.{osd_id}"
        #: where this OSD's GF applies run: the context's device, ``cuda``
        #: unless the cluster was built with ``device="cpu"``
        self.device = resolve_device(cct.device)
        if store is not None:
            self.store = store
        else:
            # config-driven backend (reference: OSD reads `osd objectstore`)
            kind = cct.conf.get("objectstore")
            if kind == "memstore":
                self.store = MemStore()
            else:
                import os

                from ..store.object_store import create_store

                data_dir = cct.conf.get("osd_data") or None
                if data_dir:
                    # per-daemon subdir (reference: osd_data defaults to
                    # /var/lib/ceph/osd/$cluster-$id — never shared)
                    data_dir = os.path.join(data_dir, self.whoami)
                self.store = create_store(
                    kind,
                    data_dir,
                    compression=cct.conf.get("objectstore_compression"),
                    sync=cct.conf.get("objectstore_wal_sync"),
                    checksum=cct.conf.get("objectstore_checksum"),
                    device_size=cct.conf.get("bluestore_block_size"),
                )
                if cct.conf.get("osd_fsck_on_mount"):
                    # boot-time consistency pass over the freshly
                    # mounted (WAL-replayed) store (reference:
                    # bluestore_fsck_on_mount)
                    errs = self.store.fsck()
                    bad = (
                        errs.get("errors") if isinstance(errs, dict)
                        else errs
                    )
                    if bad:
                        raise RuntimeError(
                            f"{self.whoami} fsck on mount: {bad}"
                        )
        # tag the store with its owner so store-layer failpoints
        # (osd.store.write_before/after_commit) can match per-daemon —
        # both by entity name (thrasher-style entries) and by context
        # (config/admin-socket-scoped entries)
        self.store.fp_entity = self.whoami
        self.store.fp_cct = cct
        self.messenger = Messenger.create(cct, self.whoami)
        self.messenger.default_policy = POLICY_LOSSLESS_PEER
        self.messenger.add_dispatcher(self)
        # ticket validation tracks the map's auth generation, so `auth
        # rotate` cuts stale clients off as soon as this OSD sees the
        # new epoch (reference: rotating service keys via MAuth)
        self.messenger.auth_gen_provider = lambda: (
            self.osdmap.auth_gens.get("osd", 1) if self.osdmap else 1
        )
        self.mc = MonClient(cct, mon_addrs, name=f"{self.whoami}-monc")
        self.osdmap: OSDMap | None = None
        #: (map, its shared placements) — _acting's memo
        self._acting_memo: tuple = (None, _Placements())
        self.pgs: dict[str, PGState] = {}
        self._pgs_lock = make_lock("osd::pgs")
        self._lock = make_lock("osd::daemon")
        self._cond = threading.Condition(self._lock)
        self._sub_replies: dict[int, dict] = {}   # tid -> reply fields
        # cephstorm: freshest piggybacked load per peer OSD —
        # {osd id: (monotonic ts, mclock qlen, sentinel degraded)} from
        # sub-op reply telemetry; _plan_repair_read's cost-aware helper
        # choice reads it (stale entries past osd_repair_telemetry_ttl
        # are ignored, falling back to index order)
        self._peer_load: dict[int, tuple] = {}
        self._tid = 0
        self._stop = threading.Event()
        self._tick_thread: threading.Thread | None = None
        self._hb_failures: dict[int, int] = {}
        self._hb_reported: set[int] = set()  # peers we told the mon are down
        self._addr: tuple | None = None       # set once the first boot is acked
        self._reboot_thread: threading.Thread | None = None
        self._codecs: dict[str, object] = {}
        self._recovery_wakeup = threading.Event()
        # mClock QoS dispatch (reference: osd_mclock_profile
        # balanced-ish): client I/O keeps a reservation floor; recovery
        # and scrub share leftovers under ceilings.  cephqos grows the
        # client side into bounded DYNAMIC per-(client,pool) classes
        # (keyed by the cephmeter accounting identity) so the mgr's QoS
        # controller can retune individual tenants; the background
        # classes stay static and keep their floors (docs/qos.md)
        self._qos_classes = bool(cct.conf.get("osd_mclock_client_classes"))
        self.scheduler = MClockScheduler(
            {
                "client": QoSParams(reservation=100.0, weight=10.0),
                "background_recovery": QoSParams(
                    reservation=10.0, weight=2.0, limit=200.0
                ),
                "background_scrub": QoSParams(weight=1.0, limit=50.0),
            },
            max_dynamic=(
                int(cct.conf.get("osd_mclock_max_client_classes"))
                if self._qos_classes else 0
            ),
            # per-client default mirrors the static client class, so
            # flipping dynamic classes on changes attribution, not QoS
            dynamic_params=QoSParams(reservation=100.0, weight=10.0),
            # bounded client-op execution (reference: osd_op_tp's fixed
            # thread count): while all slots are busy, dynamic classes
            # are ineligible to dequeue, so mClock's tags decide who
            # runs NEXT — an unbounded pool would drain the queue
            # instantly and the tags would order nothing.  Internal
            # OSD-to-OSD forwards ride the exempt static "client"
            # class (deadlock-free forwarding)
            client_slots=int(cct.conf.get("osd_mclock_client_slots")),
        )
        # monotonically increasing settings epoch: stale controller
        # pushes (reordered frames, a deposed mgr) must not roll QoS
        # back; flipped under self._lock
        self._qos_epoch = 0
        # per-class depth/served/wait as labeled prometheus series
        # (perf dump -> MMgrReport -> prometheus; docs/qos.md)
        cct.perf.add(SchedulerPerf(self.scheduler))
        self._workers: list[threading.Thread] = []
        # op-thread watchdog (reference: HeartbeatMap / osd_op_thread_
        # timeout): _run_op stamps ident -> [name, class, start,
        # last_warn]; the tick loop complains about entries older than
        # the grace.  Keyed by thread ident, not name — concurrent
        # client ops share the "-op" thread name
        self._worker_busy: dict[int, list] = {}
        self._worker_busy_lock = make_lock("osd::op_watchdog")
        self._recovery_inflight = False
        self._split_inflight = False
        self._sentinel_held = False  # flipped under self._lock
        self._pool_observer = None  # conf observer, deregistered at stop
        self._clone_mutex = make_lock("osd::snap_clone")
        # watch/notify state (reference: PrimaryLogPG watchers): primary-
        # local; clients re-register lingering watches on map change
        self.watchers: dict[tuple, dict[int, str]] = {}
        self._watch_lock = make_lock("osd::watch")
        self._client_conns: dict[str, object] = {}
        self._watch_cond = threading.Condition()
        self._notify_acks: dict[tuple[int, int], bool] = {}
        self._last_scrub = 0.0
        self._scrubs_queued: set[str] = set()
        # reference: OSD::create_logger (l_osd_op / l_osd_op_w / ...)
        self.logger = cct.perf.add(
            PerfCountersBuilder("osd")
            .add_u64_counter("op", "client operations")
            .add_u64_counter("op_w", "client writes")
            .add_u64_counter("op_r", "client reads")
            .add_u64_counter("op_w_bytes", "bytes written")
            .add_u64_counter("op_r_bytes", "bytes read")
            .add_time_avg("op_latency", "op latency")
            .add_u64_counter("recovery_ops", "objects pushed in recovery")
            .add_u64_counter("stray_probes", "stray-location probes sent")
            .add_u64_counter("subop_w", "shard sub-writes applied")
            .add_u64_counter("scrubs", "PG scrubs completed")
            .add_u64_counter("scrub_errors", "shard inconsistencies found")
            .add_u64_counter("scrub_repairs", "shards repaired by scrub")
            .add_u64_counter("tier_promote", "cache-tier promotions")
            .add_u64_counter("tier_flush", "cache-tier flushes")
            .add_u64_counter("tier_evict", "cache-tier evictions")
            .add_u64_counter("ec_batch_flushes",
                             "coalesced encode batches flushed")
            .add_u64_counter("ec_batch_stripes",
                             "stripes encoded through the write batcher")
            .add_u64_counter("ec_batch_bytes",
                             "data bytes encoded through the write batcher")
            .add_u64_counter("ec_batch_inline",
                             "stripes encoded inline (coalescing off)")
            .add_time_avg("ec_batch_flush_latency",
                          "coalesced flush latency")
            # cephread: the coalesced READ plane (osd/read_batcher.py)
            # and the primary's hot-object cache (osd/read_cache.py);
            # rides the same perf dump -> MMgrReport -> prometheus
            # pipeline as the write-batcher series
            .add_u64_counter("read_batcher_flushes",
                             "coalesced read batches flushed")
            .add_u64_counter("read_batcher_ops",
                             "gather/decode ops through the read batcher")
            .add_u64_counter("read_batcher_bytes",
                             "bytes gathered/decoded through the read "
                             "batcher")
            .add_u64_counter("read_batcher_inline",
                             "read ops served inline (coalescing off)")
            .add_time_avg("read_batcher_flush_latency",
                          "coalesced read-flush latency")
            .add_u64_counter("read_cache_hits",
                             "hot-object cache hits")
            .add_u64_counter("read_cache_misses",
                             "hot-object cache misses")
            .add_u64_counter("read_cache_inserts",
                             "objects promoted into the read cache")
            .add_u64_counter("read_cache_evictions",
                             "read-cache LRU evictions (byte bound)")
            .add_u64_counter("read_cache_invalidations",
                             "read-cache entries dropped by write-path "
                             "version bumps")
            # per-stage latency histograms (cephtrace aggregation;
            # log2 buckets, reference: PerfHistogram).  Names match the
            # span taxonomy in common/tracer.py OP_STAGES exactly.
            .add_time_histogram("stage_admission",
                                "write-batcher admission-throttle wait")
            .add_time_histogram("stage_queue",
                                "stripe coalescing wait (queued to "
                                "flush start)")
            .add_time_histogram("stage_encode",
                                "fused device encode per flush")
            .add_time_histogram("stage_subop",
                                "sub-op fan-out to last shard ack")
            .add_time_histogram("stage_commit",
                                "local object-store commit")
            # cephread client-plane stages (the trace tree grows
            # read-side spans): gather = chunk fan-out wall time,
            # decode = degraded reconstruct (ranged or full)
            .add_time_histogram("stage_read_gather",
                                "read chunk gather (batched fan-out or "
                                "per-op)")
            .add_time_histogram("stage_read_decode",
                                "degraded-read decode (ranged window "
                                "or full stripe)")
            # background-plane stage histograms (cephheal): names match
            # tracer.BG_STAGES / the recovery and scrub span taxonomy
            # verbatim, like stage_* matches OP_STAGES
            .add_time_histogram("recovery_peer",
                                "recovery peer-query round (MPGQuery "
                                "versions + object lists)")
            .add_time_histogram("recovery_pull",
                                "authoritative-log catch-up wait "
                                "(MPGPull to donor reply)")
            .add_time_histogram("recovery_rebuild",
                                "one shard chunk rebuilt (helper "
                                "gather + decode)")
            .add_time_histogram("recovery_push",
                                "one peer's push round (delta replay "
                                "or backfill)")
            .add_time_histogram("scrub_read",
                                "shard ScrubMap collection")
            .add_time_histogram("scrub_compare",
                                "cross-shard digest comparison")
            .add_time_histogram("scrub_repair",
                                "flagged-shard rebuild + re-push")
            .add_u64_counter("recovery_errors",
                             "per-PG recovery passes that raised "
                             "(previously a dout-level-1 line only)")
            .add_u64("numpg", "placement groups hosted")
            .create_perf_counters()
        )
        # cephheal: per-(pool,codec) repair-bandwidth table — helper
        # shards/bytes read vs bytes repaired, the live CLAY-vs-RS
        # repair ratio (common/recovery_accounting.py); duck-types
        # PerfCounters so the labeled rows ride perf dump ->
        # MMgrReport -> prometheus as ceph_recovery_*{pool,codec}
        self.recovery_acct = cct.perf.add(RecoveryAccounting())
        # why a rebuild's planned repair read gave way to the broad
        # gather: reason -> count (recovery.py, _plan_bail)
        self.plan_bailouts: dict[str, int] = {}
        self._bail_lock = threading.Lock()
        # consecutive _recover_pg failures per PG (satellite: a PG
        # failing every tick must surface in RECOVERY_STALLED, not
        # scroll away in logs); pgid -> [count, last_error], under
        # self._lock (recovery worker writes, report tick reads)
        self._recovery_failures: dict[str, list] = {}
        # the process-wide kernel telemetry registry rides this daemon's
        # perf pipeline (perf dump -> MMgrReport -> prometheus): kernels
        # are per-process, so every OSD in a LocalCluster reports the
        # same shared "kernel" subsystem (docs/observability.md)
        if cct.perf.get(TELEMETRY.perf.name) is None:
            cct.perf.add(TELEMETRY.perf)
        # cephplace satellite: the sentinel's per-device probe rows ride
        # the same pipeline as ceph_backend_device_*{device} labeled
        # series (one row per CUDA device, verdict + probe latency)
        if cct.perf.get(DEVICE_PERF.name) is None:
            cct.perf.add(DEVICE_PERF)
        # coalescing encode layer in front of the GF codec (the batched
        # write path; osd/write_batcher.py, docs/write_path.md)
        self.write_batcher = WriteBatcher(cct, logger=self.logger,
                                          entity=self.whoami,
                                          device=self.device)
        # cephread: the coalescing gather/decode layer behind _ec_read
        # (osd/read_batcher.py; this OSD is its transport adapter via
        # ECBackendMixin's rb_* methods) plus the primary's hot-object
        # cache (osd/read_cache.py, byte-bounded, runtime-resizable)
        self.read_batcher = ReadBatcher(cct, io=self, logger=self.logger,
                                        entity=self.whoami,
                                        device=self.device)
        self.read_cache = ReadCache(
            int(cct.conf.get("osd_read_cache_bytes")), logger=self.logger)
        cct.conf.add_observer(
            ["osd_read_cache_bytes"],
            lambda _n, v: self.read_cache.set_max_bytes(int(v)))
        # in-flight + historic op tracking (reference: OSD's OpTracker;
        # src/common/TrackedOp.cc — serves dump_ops_in_flight /
        # dump_historic_ops on the admin socket and feeds the SLOW_OPS
        # health check through the mgr digest)
        self.op_tracker = OpTracker(
            history_size=int(cct.conf.get("osd_op_history_size")),
            complaint_time=float(cct.conf.get("osd_op_complaint_time")),
            recent_slow_window=float(cct.conf.get("osd_slow_op_window")),
        )
        # cephmeter: per-(client,pool) accounting — the labels are the
        # future mClock QoS tags (common/io_accounting.py).  The table
        # duck-types PerfCounters, so adding it to cct.perf makes the
        # labeled series ride perf dump -> MMgrReport -> prometheus
        # with zero new wire plumbing (docs/observability.md)
        self.io_acct: IOAccounting | None = None
        if cct.conf.get("osd_client_io_accounting"):
            self.io_acct = IOAccounting(
                "client_io",
                top_k=int(cct.conf.get("osd_client_io_top_k")),
            )
            cct.perf.add(self.io_acct)
        if cct.admin_socket is not None:
            cct.admin_socket.register_command(
                "dump_ops_in_flight",
                lambda c: self.op_tracker.dump_ops_in_flight(),
                "ops currently executing",
            )
            cct.admin_socket.register_command(
                "dump_historic_ops",
                lambda c: self.op_tracker.dump_historic_ops(),
                "recently completed ops",
            )
            cct.admin_socket.register_command(
                "dump_historic_bg_ops",
                lambda c: self.op_tracker.dump_historic_bg_ops(),
                "recently completed background (recovery/scrub) ops "
                "with per-stage attribution (cephheal)",
            )
            cct.admin_socket.register_command(
                "dump_historic_slow_ops",
                lambda c: self.op_tracker.dump_historic_slow_ops(),
                "completed slow ops with per-stage attribution and "
                "(when cephtrace kept or tail-promoted the trace) the "
                "assembled cross-entity trace tree",
            )
            cct.admin_socket.register_command(
                "dump_op_queue",
                lambda c: self.scheduler.dump(),
                "mClock per-class queue depth, served ops, wait "
                "histograms, and (reservation, weight, limit) params "
                "(docs/qos.md)",
            )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.store.mount()
        addr = self.messenger.bind(("127.0.0.1", 0))
        self.messenger.start()
        self.mc.subscribe_osdmap(callback=self._on_map)
        self.mc.fetch_config(self.cct)  # central config (mon db)
        self.osdmap = self._boot(addr)
        self._addr = addr
        self._load_pgs()
        # cephdma: device stripe pool sized/armed from THIS daemon's
        # conf (process-wide like the sentinel — first daemon at boot
        # wins the bound; the batcher re-reads ec_device_pool per flush
        # so the hatch stays runtime there, and an EXPLICIT injectargs
        # flips the process-wide pool too via the observer — that's
        # what lets the hatch disengage the stream/decode/recovery
        # paths, which consult only POOL.enabled())
        # (the reference also builds a device-topology policy here; the
        # port's daemon runs on the one device its context names,
        # common/device.py)
        from ..ops.device_pool import POOL, configure_from_conf

        configure_from_conf(self.cct.conf)
        # keep the callback so shutdown can deregister it — a stopped
        # OSD reacting to a later injectargs would flip the
        # process-wide pool on behalf of a corpse
        self._pool_observer = lambda _n, v: POOL.configure(
            enabled=bool(v))
        self.cct.conf.add_observer(["ec_device_pool"],
                                   self._pool_observer)
        self.write_batcher.start()
        self.read_batcher.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name=f"{self.whoami}-tick", daemon=True
        )
        self._tick_thread.start()
        # op worker pool draining the mClock queue (reference: osd_op_tp)
        for i in range(2):
            t = threading.Thread(
                target=self._op_worker, name=f"{self.whoami}-op-{i}",
                daemon=True,
            )
            self._workers.append(t)
            t.start()
        # backend health sentinel (common/kernel_telemetry.py): policy
        # built from THIS daemon's conf and constructor-injected — the
        # sentinel itself is process-wide (kernel dispatch is), refs
        # counted across the local daemons; interval <= 0 disables.
        # Brought up LAST: a later bring-up failure escaping start()
        # would strand the refcount no later daemon can retire
        si = float(self.cct.conf.get("backend_sentinel_interval"))
        if si > 0:
            SENTINEL.acquire(SentinelPolicy(
                interval=si,
                timeout=float(self.cct.conf.get("backend_sentinel_timeout")),
            ))
            with self._lock:
                self._sentinel_held = True

    def _op_worker(self) -> None:
        while not self._stop.is_set():
            picked = self.scheduler.dequeue(timeout=1.0)
            if picked is None:
                continue
            cls, work = picked
            if cls in ("background_recovery", "background_scrub"):
                # background work runs inline: worker count bounds its
                # concurrency, which is the point of the QoS classes
                self._run_op(work, cls)
            else:
                # client-side classes ("client", per-client dynamic,
                # "_default_"): mClock orders ADMISSION; execution gets
                # its own thread so a client op blocked on a slow
                # peer's sub-op never pins a worker that background
                # work (or the recovery that would fix the peer) needs.
                # Dynamic-class ops consumed a client-op slot at the
                # pick (the bound that makes the tags bite); the
                # executor returns it via client_op_done()
                threading.Thread(  # noqa: CL13 — fire-and-forget by design: per-op executor; its lifetime is the op's, and the scheduler's inflight slot (returned via client_op_done) bounds the population
                    target=self._run_client_op,
                    args=(work, cls, cls != "client"),
                    name=f"{self.whoami}-op", daemon=True,
                ).start()

    def _run_client_op(self, work, cls: str, slotted: bool) -> None:
        try:
            self._run_op(work, cls)
        finally:
            if slotted and self.scheduler.client_slots > 0:
                self.scheduler.client_op_done()

    def _run_op(self, work, cls: str = "client") -> None:
        th = threading.current_thread()
        now = time.monotonic()
        with self._worker_busy_lock:
            self._worker_busy[th.ident] = [th.name, cls, now, now]
        try:
            work()
        except Exception as e:
            self.cct.dout("osd", 0, f"{self.whoami} op failed: {e!r}")
        finally:
            with self._worker_busy_lock:
                self._worker_busy.pop(th.ident, None)

    def _check_op_workers(self, now: float) -> None:
        """Complain about workers stuck past osd_op_thread_timeout
        (reference: HeartbeatMap::is_healthy's 'had timed out' log)."""
        grace = float(self.cct.conf.get("osd_op_thread_timeout"))
        with self._worker_busy_lock:
            entries = [e for e in self._worker_busy.values()
                       if now - e[2] >= grace and now - e[3] >= grace]
            for e in entries:
                e[3] = now
        for tname, cls, start, _ in entries:
            self.cct.dout(
                "osd", 0,
                f"{self.whoami} worker {tname} ({cls}) stuck for "
                f"{now - start:.1f}s (osd_op_thread_timeout {grace:.0f}s)")

    def shutdown(self, umount: bool = True) -> None:
        """umount=False is the thrasher's CRASH kill: threads stop but
        the store is dropped without a graceful unmount, so a revive
        from the same directory exercises real WAL replay + fsck."""
        self._stop.set()
        try:
            self.scheduler.stop()
        except Exception as e:
            self.cct.dout("osd", 0,
                          f"{self.whoami} scheduler stop raised: {e!r}")
        self._recovery_wakeup.set()
        # wake every blocked sub-op wait (_wait_reply/_wait_replies are
        # stop-aware) so the worker joins below don't sit out the
        # osd_subop_reply_timeout of an in-flight recovery pull
        with self._lock:
            self._cond.notify_all()
        # teardown reverses bring-up, each step best-effort (one bad
        # subsystem must not strand the rest, mgr/daemon.py style):
        # the sentinel ref first (bring-up's last step), then op
        # workers and the tick thread (they submit through everything
        # below), the coalescers (queued stripes flush — their ops
        # complete or fail normally — before the messenger goes away),
        # the conf observer, the transports, and last the store.
        # Test-and-set under the daemon lock (double-shutdown must not
        # double-release the refcounted sentinel)
        with self._lock:
            release_sentinel = self._sentinel_held
            self._sentinel_held = False
        if release_sentinel:
            try:
                SENTINEL.release()
            except Exception as e:
                self.cct.dout(
                    "osd", 0,
                    f"{self.whoami} sentinel release raised: {e!r}")
        for t in self._workers:
            t.join(timeout=5)
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=5)
        with self._lock:
            reboot = self._reboot_thread
        if reboot is not None:
            reboot.join(timeout=5)
        try:
            self.read_batcher.stop()
        except Exception as e:
            self.cct.dout("osd", 0,
                          f"{self.whoami} read batcher stop raised: "
                          f"{e!r}")
        try:
            self.write_batcher.stop()
        except Exception as e:
            self.cct.dout("osd", 0,
                          f"{self.whoami} write batcher stop raised: "
                          f"{e!r}")
        if self._pool_observer is not None:
            try:
                self.cct.conf.remove_observer(self._pool_observer)
            except Exception as e:
                self.cct.dout(
                    "osd", 0,
                    f"{self.whoami} observer removal raised: {e!r}")
            self._pool_observer = None
        try:
            self.mc.shutdown()
        except Exception as e:
            self.cct.dout("osd", 0,
                          f"{self.whoami} mon client shutdown raised: "
                          f"{e!r}")
        try:
            self.messenger.shutdown()
        except Exception as e:
            self.cct.dout("osd", 0,
                          f"{self.whoami} messenger shutdown raised: "
                          f"{e!r}")
        if umount:
            try:
                self.store.umount()
            except Exception as e:
                self.cct.dout("osd", 0,
                              f"{self.whoami} store umount raised: {e!r}")
        # the context goes last: its admin socket serves debug commands
        # (perf dump, failpoints) right up until the daemon is gone
        self.cct.shutdown()

    def _boot(self, addr: tuple) -> OSDMap | None:
        """Resend boot until a map shows this OSD up at `addr`, and
        return that map (None if the OSD stops first; reference: OSD
        re-sends MOSDBoot until it sees itself up) — a boot riding a
        connection that resets mid-handshake would otherwise be lost."""
        deadline = time.monotonic() + 30.0
        min_epoch = 1
        while not self._stop.is_set():
            try:
                self.mc.send_boot(self.id, addr)
            except (OSError, ConnectionError):
                pass
            try:
                m = self.mc.wait_for_osdmap(min_epoch=min_epoch, timeout=2.0)
            except TimeoutError:
                m = self.mc.osdmap
            if m is not None:
                if (m.is_up(self.id) and
                        tuple(m.osd_addrs.get(self.id) or ()) == tuple(addr)):
                    return m
                # wait for a NEWER epoch next round so the retry loop
                # blocks instead of spinning on the same stale map
                min_epoch = m.epoch + 1
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{self.whoami}: boot not acknowledged in 30s"
                )
        return None

    def _reboot(self) -> None:
        try:
            self._boot(self._addr)
        except TimeoutError as e:
            self.cct.dout("osd", 0, f"{self.whoami}: re-boot failed: {e}")
        finally:
            with self._lock:
                self._reboot_thread = None

    def _check_wrongly_down(self, m: OSDMap) -> None:
        """A map that shows this running OSD down, at its own address or
        none, came from failure reports that outlived an earlier
        incarnation (peers count silent pings across a kill and revive):
        boot again (reference: OSD::handle_osd_map's "wrongly marked me
        down" and start_boot).  The boot loop waits for maps, which
        arrive on this callback's thread, so it runs on its own."""
        if self._addr is None or self._stop.is_set() or m.is_up(self.id):
            return
        at = m.osd_addrs.get(self.id)
        if at is not None and tuple(at) != tuple(self._addr):
            return
        with self._lock:
            if self._reboot_thread is not None:
                return
            self.cct.dout("osd", 0, f"{self.whoami}: map e{m.epoch} wrongly "
                                    "marked me down; booting again")
            self._reboot_thread = threading.Thread(
                target=self._reboot, name=f"{self.whoami}-reboot", daemon=True)
            self._reboot_thread.start()

    # -- map handling ------------------------------------------------------
    def _on_map(self, m: OSDMap) -> None:
        old = self.osdmap
        self.osdmap = m
        self._check_wrongly_down(m)
        if old is not None:
            # interval bookkeeping (same_interval_since): a PG whose
            # up/acting changed starts a NEW interval at this epoch
            with self._pgs_lock:
                pgs = list(self.pgs.values())
            old_memo = self._acting_memo
            if old_memo[0] is not old:
                old_memo = (old, _placements_of(old))
            new_memo = self._memo_for(m)
            for pg in pgs:
                try:
                    o = _placed(old_memo, pg.pool_id, pg.ps)
                    n = _placed(new_memo, pg.pool_id, pg.ps)
                except Exception as e:
                    # pool deleted between the two epochs (or a map too
                    # old to place against) — the PG is on its way out
                    self.cct.dout("osd", 10,
                                  f"{self.whoami} interval check skipped "
                                  f"pg {pg.pool_id}.{pg.ps:x}: {e!r}")
                    continue
                if (o[2], o[3]) != (n[2], n[3]):
                    # close the old interval into the history BEFORE
                    # starting the new one (reference: check_new_interval)
                    old_pool = old.pools.get(pg.pool_id)
                    went_rw = (
                        o[3] >= 0
                        and old_pool is not None
                        and sum(1 for a in o[2] if a >= 0)
                        >= old_pool.min_size
                    )
                    # under pg.lock: recovery's clean-broadcast block
                    # clears past_intervals under the same lock, and an
                    # unserialized interleave here could close an
                    # interval into a history recovery just wiped
                    with pg.lock:
                        pg.past_intervals.add(
                            first=pg.interval_start or old.epoch,
                            last=m.epoch - 1,
                            up=list(o[0]), acting=list(o[2]), primary=o[3],
                            maybe_went_rw=went_rw,
                        )
                        pg.intervals_closed += 1
                        pg.interval_start = m.epoch
                    self._save_intervals(pg)
        if (old is None or old.max_pool_id != m.max_pool_id
                or set(old.pools) - set(m.pools)):
            self._purge_deleted_pools(m)
        self._recovery_wakeup.set()  # re-peer with the new map

    def _purge_deleted_pools(self, m: OSDMap) -> None:
        """Local PG state for any pool absent from the map is garbage
        (reference: the OSD's PG removal queue after pool deletion).
        Checked against the full map, not an old->new diff, so an OSD
        that was down across the deletion still purges on its first map
        after boot — _load_pgs resurrects PGs from leftover collections.
        Pool ids are monotonic (OSDMap.max_pool_id), which makes the
        check race-free against map lag: a collection whose pool id is
        ABOVE this map's max_pool_id belongs to a pool created in an
        epoch we haven't applied yet (a lagging replica can take a
        sub-op for it before seeing the map) and must be left alone;
        one at or below it that is absent from the map is definitively
        deleted, because ids are never reused."""

        def _pool_of(key: str) -> int:
            head = key.split(".", 1)[0]
            return int(head) if head.isdigit() else -1

        live = set(m.pools)
        ceiling = m.max_pool_id

        def _doomed(pid: int) -> bool:
            return 0 <= pid <= ceiling and pid not in live

        with self._pgs_lock:
            doomed = [k for k in self.pgs if _doomed(_pool_of(k))]
            for key in doomed:
                del self.pgs[key]
        for cid in list(self.store.list_collections()):
            pid = _pool_of(cid)
            if not _doomed(pid):
                continue
            try:
                t = Transaction()
                for oid in list(self.store.list_objects(cid)):
                    t.remove(cid, oid)
                t.remove_collection(cid)
                self.store.queue_transaction(t)
            except Exception as e:
                self.cct.dout(
                    "osd", 3,
                    f"{self.whoami} pool {pid} purge {cid}: {e!r}")

    def my_epoch(self) -> int:
        return self.osdmap.epoch if self.osdmap else 0

    # -- helpers -----------------------------------------------------------
    def _codec_for_pool(self, pool):
        """Per-profile compiled codec cache (reference: ECBackend holds its
        ErasureCodeInterfaceRef; SURVEY.md §2.9 'per-profile kernel cache')."""
        name = pool.ec_profile or ""
        codec = self._codecs.get(name)
        if codec is None:
            profile = dict(self.osdmap.ec_profiles.get(name) or {})
            profile.setdefault("plugin", "torch")
            # ec_kernel: 'numpy' swaps the whole backend for the default
            # plugin.  The reference's 'xla'/'pallas' picked the GF kernel
            # inside its device backend; the port has one path per device
            # (K1/K2 on the card, their plain version on the CPU), so
            # those two select nothing.  'oracle' waits for the native
            # plugins (ROADMAP queue 1 item 5).
            kern = str(self.cct.conf.get("ec_kernel"))
            if kern == "oracle":
                raise NotImplementedError(
                    "ec_kernel=oracle: the oracle plugin is not ported yet "
                    "(ROADMAP queue 1 item 5)")
            if kern == "numpy" and profile["plugin"] == "torch":
                profile["plugin"] = kern
            codec = ErasureCodePluginRegistry.instance().factory(
                profile, device=self.device)
            self._codecs[name] = codec
        return codec

    def _memo_for(self, m: OSDMap) -> tuple:
        memo = self._acting_memo
        if memo[0] is not m:
            memo = self._acting_memo = (m, _placements_of(m))
        return memo

    def _acting(self, pool_id: int, ps: int) -> tuple[list[int], int]:
        """A PG's acting set and primary under this OSD's current map,
        from the process's shared placements (``_placements_of``): an
        OSDMap the OSD holds is never mutated (a new epoch arrives as a
        new object, ``_on_map``), and the scalar CRUSH descent behind it
        runs on the host for every PG on every tick."""
        got = _placed(self._memo_for(self.osdmap), pool_id, ps)
        return list(got[2]), got[3]

    def _pg(self, pool_id: int, ps: int) -> PGState:
        pgid = f"{pool_id}.{ps}"
        with self._pgs_lock:
            pg = self.pgs.get(pgid)
            if pg is None:
                pg = PGState(pgid, pool_id, ps)
                self._load_pg_meta(pg)
                # an OSD (re)booting IS an interval change for its PGs:
                # without this a revived OSD would accept sub-ops from a
                # primary deposed while it was down (interval_start=0
                # would pass everything)
                pg.interval_start = self.my_epoch()
                self.pgs[pgid] = pg
            return pg

    def _cid(self, pgid: str, shard: int) -> str:
        return f"{pgid}s{shard}"

    def _conn_to_osd(self, osd: int):
        addr = self.osdmap.osd_addrs.get(osd)
        if addr is None:
            raise ConnectionError(f"no address for osd.{osd}")
        conn = self.messenger.connect(tuple(addr))
        if not conn.peer_name:
            # dialer-side identity: lets send-path failpoints match on
            # the peer before any reply has arrived
            conn.peer_name = f"osd.{osd}"
        return conn

    def _next_tid(self) -> int:
        with self._lock:
            self._tid += 1
            return self._tid

    # -- cephtrace op-stage funnel -----------------------------------------
    def _op_stage(self, stage: str, t0: float, t1: float, span=None,
                  **tags) -> None:
        """ONE helper for op-stage bookkeeping: the stage histogram,
        the TrackedOp event (dump_historic_ops offsets), and the
        cephtrace span all share one clock (tracer.trace_now) and one
        stage name — they cannot drift apart (the double-booked-
        timestamp bug this replaces).  Stage names: tracer.OP_STAGES.
        `span` closes a pre-opened span (the subop fan-out opens its
        span BEFORE sending so sub-op messages can carry its id as
        their parent) instead of minting a fresh one."""
        self._stage_funnel(f"stage_{stage}", stage, t0, t1, span, tags)

    def _stage_funnel(self, counter: str, stage: str, t0: float,
                      t1: float, span, tags: dict) -> None:
        """The shared histogram + TrackedOp + span funnel behind
        _op_stage (client plane, `stage_*` counters) and _bg_stage
        (background plane, bare BG_STAGES counters)."""
        self.logger.hinc(counter, t1 - t0)
        st = op_trace()
        if st is None:
            TRACER.end(span, t1=t1, **tags)
            return
        tracked = st.get("tracked")
        if tracked is not None:
            tracked.mark_event(stage, ts=t1)
            # cephmeter: accumulated per-stage duration, so a slow op's
            # dump_historic_slow_ops entry names the dominant stage
            tracked.stage_add(stage, t1 - t0)
        if span is not None:
            TRACER.end(span, t1=t1, **tags)
            return
        ctx = st.get("ctx")
        if ctx is not None:
            TRACER.record(ctx, stage, entity=self.whoami, t0=t0, t1=t1,
                          **tags)

    def _op_trace_ctx(self):
        """Current op's trace context (None = unsampled / tracing off)."""
        st = op_trace()
        return st.get("ctx") if st is not None else None

    # -- cephheal background-op funnel ---------------------------------
    def _bg_stage(self, stage: str, t0: float, t1: float, span=None,
                  **tags) -> None:
        """_op_stage's background twin: one call feeds the recovery_*/
        scrub_* latency histogram, the TrackedOp stage attribution, and
        the cephtrace span — one clock, one stage name (tracer.
        BG_STAGES, which IS the counter name).  The histogram fills
        whether or not tracing is on; the span side is the usual
        one-attribute-check no-op when off."""
        self._stage_funnel(stage, stage, t0, t1, span, tags)

    def _bg_trace_ctx(self):
        """Root context for a background op (recovery pass, scrub):
        the SAME head-coin-flip + tail-provisional contract client ops
        get at op_submit, so a slow recovery keeps its connected tree
        even at trace_sampling_rate=0 (docs/tracing.md)."""
        if not TRACER.enabled:
            return None
        return sampled_ctx(
            float(self.cct.conf.get("trace_sampling_rate")),
            tail=float(self.cct.conf.get("trace_tail_latency_ms")) > 0,
        )

    def _bg_tail_verdict(self, tracked) -> None:
        """Promote-or-discard a background op's provisionally buffered
        trace on completion (the client-side Objecter verdict has no
        analog here — the background op IS its own client)."""
        tid = tracked.trace_id
        if tid is None:
            return
        dur = tracked.duration()
        complaint = self.op_tracker.complaint_time
        tail_ms = float(self.cct.conf.get("trace_tail_latency_ms"))
        if complaint > 0 and dur > complaint:
            TRACER.promote(tid, reason=f"{tracked.src}_complaint")
        elif tail_ms > 0 and dur * 1e3 >= tail_ms:
            TRACER.promote(tid, reason=f"{tracked.src}_tail")
        elif TRACER.is_provisional(tid):
            TRACER.discard(tid)

    def _codec_label(self, pool) -> str:
        """(pool, codec) label for the repair-bandwidth rows: the EC
        profile's plugin (+technique when set), or 'replica'."""
        from ..osd.osdmap import PG_POOL_ERASURE

        if pool is None:
            return "?"
        if pool.type != PG_POOL_ERASURE:
            return "replica"
        prof = ((self.osdmap.ec_profiles if self.osdmap else {})
                .get(pool.ec_profile or "") or {})
        plugin = str(prof.get("plugin", "torch"))
        tech = prof.get("technique")
        return f"{plugin}-{tech}" if tech else plugin

    # -- persistence of PG meta -------------------------------------------
    def _load_pgs(self) -> None:
        for cid in self.store.list_collections():
            if "s" not in cid or "." not in cid:
                continue
            pgid = cid.rsplit("s", 1)[0]
            pool_id, ps = pgid.split(".")
            self._pg(int(pool_id), int(ps))

    def _load_pg_meta(self, pg: PGState) -> None:
        from .past_intervals import PastIntervals

        # any shard collection of this pg carries the meta object
        for cid in self.store.list_collections():
            if cid.rsplit("s", 1)[0] != pg.pgid:
                continue
            try:
                pairs = self.store.omap_get(cid, pg.meta_oid())
            except (NotFound, KeyError):
                continue
            head = int(pairs.get("head", b"0"))
            tail = int(pairs.get("tail", b"0"))
            pg.log = PGLog.load(pairs, head, tail)
            pg.version = head
            pg.past_intervals = PastIntervals.from_bytes(
                pairs.get("past_intervals")
            )
            pg.last_map_epoch = int(pairs.get("last_epoch", b"0"))
            pg.meta_cids.add(cid)
            return

    def _save_intervals(self, pg: PGState) -> None:
        """Persist the interval history + rebuild floor next to the PG
        log (same meta omap; reference: PastIntervals + history ride
        pg_info_t in the pg meta).  Uses the PG's known shard
        collections (meta_cids) — a full store scan per map change was
        O(pgs x collections) on the map-handling path (review r4); the
        scan runs once, only when the cache is cold."""
        if not pg.meta_cids:
            pg.meta_cids = {
                cid for cid in self.store.list_collections()
                if cid.rsplit("s", 1)[0] == pg.pgid
            }
            if not pg.meta_cids:
                # no local collection yet (freshly assigned primary):
                # stash under the would-be-primary shard so the history
                # survives a restart
                pg.meta_cids = {self._cid(pg.pgid, 0)}
        # snapshot the two fields under pg.lock: the map thread and
        # recovery's clean-broadcast both mutate them under that lock,
        # and serializing the WRITERS is worthless if this reader can
        # still persist half of one writer's update.  The store txn
        # below stays outside the lock.
        with pg.lock:
            keys = {
                "past_intervals": pg.past_intervals.to_bytes(),
                "last_epoch": str(pg.last_map_epoch).encode(),
            }
        for cid in pg.meta_cids:
            t = Transaction()
            t.try_create_collection(cid)
            t.touch(cid, pg.meta_oid())
            t.omap_setkeys(cid, pg.meta_oid(), keys)
            self.store.queue_transaction(t)

    def _log_txn(self, t: Transaction, cid: str, pg: PGState,
                 entry: LogEntry) -> None:
        """Append the log entry + version keys to the same transaction as
        the data op (log/data atomicity, reference: PGLog::write_log)."""
        import json

        trimmed = pg.log.append(entry)
        pg.version = entry.version
        pg.last_map_epoch = self.my_epoch()
        keys = {
            PGLog.omap_key(entry.version): json.dumps(entry.to_list()).encode(),
            "head": str(pg.log.head).encode(),
            "tail": str(pg.log.tail).encode(),
            "last_epoch": str(pg.last_map_epoch).encode(),
        }
        t.touch(cid, pg.meta_oid())
        t.omap_setkeys(cid, pg.meta_oid(), keys)
        pg.meta_cids.add(cid)
        if trimmed:
            t.omap_rmkeys(
                cid, pg.meta_oid(), [PGLog.omap_key(e.version) for e in trimmed]
            )

    def _log_seal_txn(self, t: Transaction, cid: str, pg: PGState,
                      version: int) -> None:
        """Seal an empty log window at `version` (backfill completion)."""
        old_keys = [PGLog.omap_key(e.version) for e in pg.log.entries]
        pg.log.reset_to(version)
        pg.version = version
        t.touch(cid, pg.meta_oid())
        t.omap_setkeys(cid, pg.meta_oid(), {
            "head": str(version).encode(),
            "tail": str(version).encode(),
        })
        if old_keys:
            t.omap_rmkeys(cid, pg.meta_oid(), old_keys)

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, conn, msg) -> bool:
        # "osd.dispatch" (legacy: osd_debug_inject_dispatch_delay routed
        # as delay(sec)) — a delay action stalls this OSD's message
        # handling, the slow-daemon injection; an error action poisons
        # the message like a dispatcher bug would.  configured() guard:
        # this is the hottest dispatch path — stay free when off
        if fp_registry().configured("osd.dispatch"):
            failpoint("osd.dispatch", cct=self.cct, entity=self.whoami,
                      msg=type(msg).__name__)
        if isinstance(msg, MOSDOp):
            if TRACER.enabled and msg.trace_id is not None:
                # arrival stamp: _handle_client_op turns it into the
                # mClock dispatch-queue span (same trace_now clock)
                msg._rx_ts = trace_now()
            src = getattr(msg, "src", None)
            if src is not None:
                # notify fan-out reaches a watcher over the SAME
                # connection its ops arrive on (reference: the watch's
                # Session connection).  Bounded: oldest client entries
                # are dropped (their watches re-linger on the next map)
                self._client_conns.pop(src, None)
                self._client_conns[src] = conn  # re-insert: LRU position
                if len(self._client_conns) > 512:
                    self._client_conns.pop(
                        next(iter(self._client_conns)), None)
            # client ops flow through the mClock queue (reference:
            # OSD::ms_fast_dispatch -> op_shardedwq enqueue), under a
            # per-(client,pool) dynamic class when cephqos is armed —
            # the SAME identity the accounting table keys on, so the
            # controller's retuned params land on the tenants its
            # telemetry named (docs/qos.md)
            qcls = "client"
            if (self._qos_classes and src is not None
                    and not src.startswith("osd.")):
                # osd.* sources are internal forwards (split migration,
                # clone staging): they stay on the exempt static class
                # so a slot-full OSD can never deadlock a peer's op
                qcls = self.scheduler.client_class(f"{src}/{msg.pool}")
            self.scheduler.enqueue(
                qcls, lambda: self._handle_client_op(conn, msg)
            )
            return True
        if isinstance(msg, MQoSSettings):
            self._handle_qos_settings(msg)
            return True
        if isinstance(msg, MWatchNotifyAck):
            with self._watch_cond:
                self._notify_acks[(msg.notify_id, msg.cookie)] = True
                # bound the ack ledger (ids are monotonic; stale ones
                # are dead after their notify's timeout)
                while len(self._notify_acks) > 4096:
                    self._notify_acks.pop(next(iter(self._notify_acks)))
                self._watch_cond.notify_all()
            return True
        if isinstance(msg, MECSubOpWrite):
            self._handle_sub_write(conn, msg)
            return True
        if isinstance(msg, MECSubOpRead):
            self._handle_sub_read(conn, msg)
            return True
        if isinstance(msg, MPGPull):
            self._handle_pg_pull(conn, msg)
            return True
        if isinstance(
            msg,
            (MECSubOpWriteReply, MECSubOpReadReply, MPGNotify,
             MScrubShardReply, MOSDOpReply, MPGPullReply),
        ):
            # MOSDOpReply arrives when this OSD acts as its own client
            # (split migration forwarding ops to the post-split primary)
            with self._lock:
                if getattr(msg, "sender", None) is not None:
                    self._peer_load[int(msg.sender)] = (
                        time.monotonic(), int(msg.qlen or 0),
                        bool(msg.degraded))
                self._sub_replies[msg.tid] = msg
                # reap abandoned stragglers (wave replies past their
                # shared deadline — _wait_replies leaves them here).
                # tids are monotonic: evicting the oldest quarter only
                # bites a live waiter if its reply sat unclaimed while
                # 4096 newer ones arrived, far beyond any wave size
                if len(self._sub_replies) > 4096:
                    for tid in sorted(self._sub_replies)[:1024]:
                        del self._sub_replies[tid]
                self._cond.notify_all()
            return True
        if isinstance(msg, MPGQuery):
            self._handle_pg_query(conn, msg)
            return True
        if isinstance(msg, MPGClean):
            self._handle_pg_clean(msg)
            return True
        if isinstance(msg, MScrubShard):
            self._handle_scrub_shard(conn, msg)
            return True
        if isinstance(msg, MOSDPingMsg):
            if msg.op == "ping":
                try:
                    conn.send_message(
                        MOSDPingMsg(op="reply", osd=self.id, epoch=self.my_epoch())
                    )
                except (OSError, ConnectionError):
                    pass
            elif msg.op == "reply":
                self._hb_failures.pop(msg.osd, None)
                if msg.osd in self._hb_reported:
                    # we told the mon this peer was down and it just
                    # answered a ping: retract the report so the
                    # leader's corroboration count drains (reference:
                    # OSD::send_still_alive) instead of riding until
                    # the target re-boots.  Off-thread: report_alive
                    # may have to re-dial the mon, and this runs on the
                    # messenger rx thread, which must never block on a
                    # connect (the ensure_connection rule)
                    self._hb_reported.discard(msg.osd)
                    threading.Thread(  # noqa: CL13 — fire-and-forget by design: report_alive must leave the messenger rx thread (no blocking dial there) and makes one bounded send
                        target=self.mc.report_alive, args=(msg.osd,),
                        name=f"osd.{self.id}-alive", daemon=True,
                    ).start()
            return True
        return False

    def _handle_qos_settings(self, msg: MQoSSettings) -> None:
        """Apply one controller push (mgr/qos_module.py): runtime
        options go through the SAME validate-all-then-apply core as
        injectargs; per-class (reservation, weight, limit) land on the
        scheduler.  Epoch-guarded — a stale push (reordered frames, a
        deposed mgr's last tick) must not roll settings back.  The
        background classes' floors are never controller-writable."""
        epoch = int(msg.qos_epoch or 0)
        with self._lock:
            if epoch <= self._qos_epoch:
                return
            self._qos_epoch = epoch
        applied: dict = {}
        try:
            if msg.options:
                from ..common.failpoint import apply_runtime_options

                applied = apply_runtime_options(
                    self.cct, sorted(msg.options.items()))
        except Exception as e:
            self.cct.dout("osd", 1,
                          f"{self.whoami} qos push epoch {epoch} options "
                          f"rejected: {e!r}")
            TRACER.tracepoint("qos", "reject", entity=self.whoami,
                              qos_epoch=epoch, error=repr(e))
            return
        n_classes = 0
        for name, rwl in sorted((msg.classes or {}).items()):
            if name in ("background_recovery", "background_scrub"):
                continue  # background floors are not controller-writable
            try:
                r, w, li = (float(rwl[0]), float(rwl[1]), float(rwl[2]))
                # register=False: the controller fans one cluster-wide
                # class map to every OSD — identities this OSD never
                # serves must not LRU-thrash its live classes; a class
                # that appears later starts on defaults and picks up
                # the params at the next push (one controller tick)
                if self.scheduler.set_params(
                        name, QoSParams(reservation=r, weight=w, limit=li),
                        register=False):
                    n_classes += 1
            except (ValueError, TypeError, IndexError) as e:
                self.cct.dout("osd", 1,
                              f"{self.whoami} qos class {name!r} params "
                              f"{rwl!r} rejected: {e!r}")
        TRACER.tracepoint("qos", "apply", entity=self.whoami,
                          qos_epoch=epoch, options=applied,
                          classes=n_classes)

    def _wait_reply(self, tid: int, timeout: float | None = None):
        # stop-aware: shutdown notifies _cond after setting _stop, so a
        # worker blocked here (recovery pulls, sub-writes) fails fast
        # instead of burning the full sub-op timeout under join
        if timeout is None:
            timeout = float(self.cct.conf.get("osd_subop_reply_timeout"))
        with self._lock:
            self._cond.wait_for(
                lambda: tid in self._sub_replies or self._stop.is_set(),
                timeout=timeout,
            )
            return self._sub_replies.pop(tid, None)

    def _wait_replies(self, tids, deadline: float) -> dict:
        """Collect replies for MANY tids under one SHARED deadline
        (advisor r4: N sequential per-reply waits made degraded-read
        stray probing O(N * timeout); a wave is bounded by the single
        deadline).  Returns {tid: reply} for those that arrived; late
        stragglers stay in _sub_replies for the reaper."""
        out: dict = {}
        pending = set(tids)
        with self._lock:
            while pending:
                for tid in [t for t in pending if t in self._sub_replies]:
                    out[tid] = self._sub_replies.pop(tid)
                    pending.discard(tid)
                if not pending or self._stop.is_set():
                    break  # shutdown fails the wave now, not at deadline
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    # timed out: drain anything that landed, then stop
                    for tid in [t for t in pending
                                if t in self._sub_replies]:
                        out[tid] = self._sub_replies.pop(tid)
                    break
        return out

    # -- heartbeats + recovery tick ---------------------------------------
    def _tick_loop(self) -> None:
        interval = 1.0
        last_hb = 0.0
        last_mgr = 0.0
        while not self._stop.is_set():
            self._recovery_wakeup.wait(timeout=interval)
            self._recovery_wakeup.clear()
            if self._stop.is_set():
                return
            now = time.monotonic()
            try:
                hb_interval = float(
                    self.cct.conf.get("osd_heartbeat_interval"))
                if now - last_hb >= hb_interval:
                    last_hb = now
                    self._heartbeat()
                self._check_op_workers(now)
                # keep the mon subscription alive: a crashed mon would
                # otherwise leave this OSD on a stale map forever (the
                # push-based subscription has no other liveness probe);
                # non-blocking — the hunt runs on a MonClient helper
                # thread so heartbeat cadence never stalls behind it
                self.mc.ensure_connection()
                if now - last_mgr >= self.cct.conf.get("mgr_report_interval"):
                    last_mgr = now
                    self._mgr_report()
                # recovery rides the mClock queue as background work so
                # client ops keep their reservation during big recoveries.
                # test-and-set under the daemon lock: the worker's reset
                # races an unlocked check (cephrace CR1), and a lost
                # update here double-books the single recovery slot
                with self._lock:
                    start_recovery = not self._recovery_inflight
                    if start_recovery:
                        self._recovery_inflight = True
                    start_split = not self._split_inflight
                    if start_split:
                        self._split_inflight = True
                if start_recovery:
                    self.scheduler.enqueue(
                        "background_recovery", self._recover_all_work
                    )
                if start_split:
                    self.scheduler.enqueue(
                        "background_recovery", self._split_pass_work
                    )
                self._maybe_schedule_scrub(now)
            except Exception as e:
                self.cct.dout("osd", 0, f"{self.whoami} tick failed: {e!r}")

    def _recover_all_work(self) -> None:
        try:
            self._recover_all()
        finally:
            with self._lock:
                self._recovery_inflight = False

