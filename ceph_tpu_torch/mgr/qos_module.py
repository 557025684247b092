"""qos — the cephqos closed-loop controller (reference: the mgr-side
half of mClock profile tuning plus the self-tuning throttles of
src/osd/scheduler/mClockScheduler.cc::set_osd_capacity_params; ROADMAP
"Closed-loop QoS"; arXiv:1709.05365's finding that QUEUEING, not
compute, dominates online erasure coding at scale — so the knobs worth
closing the loop on are the coalescing window and the per-tenant
admission order, not the codec).

One feedback loop, three stages per tick (``mgr_qos_interval``):

1. **Observe** — its own telemetry, nothing bespoke: stage_queue /
   stage_encode p99s from the histogram BUCKET deltas of each OSD's
   latest MMgrReport (windowed: this tick minus last tick), aggregate
   write rate + stripes-per-flush from the ``metrics_history`` rate
   API (the PR-11 store), and per-(client,pool) op rates from the
   cephmeter labeled accounting rows — the SAME identities the OSD's
   dynamic mClock classes key on.
2. **Plan** — :class:`QoSController`, a pure deterministic function
   from observation to decision, clamped by declared options: the
   coalescing window follows the observed inter-arrival toward a
   half-full batch (converging fixed point) but backs off
   multiplicatively while queue p99 overshoots its target;
   ``ec_batch_max_stripes`` grows while flushes saturate it and the
   encode stage keeps up; clients whose op rate exceeds
   ``mgr_qos_bully_factor`` x the median get a heavy (low-weight)
   mClock class while the rest keep a reservation floor — weights, not
   hard limits, so the scheduler stays work-conserving and aggregate
   throughput survives.
3. **Push + export** — one :class:`~ceph_tpu_torch.mgr.messages.MQoSSettings`
   per reporting OSD, riding BACK over its report connection (options
   apply through the daemon's injectargs core; class params land on
   the scheduler), every decision logged as a ``qos`` tracepoint and
   exported as ``ceph_qos_*`` prometheus series via the mgr's own
   report sink — tuning is itself observable, and its history rides
   the same metrics_history ring it reads.

``mgr_qos_active`` = false (the default) observes and exports but
pushes nothing — the balancer's dry-run precedent.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..common.lockdep import make_lock
from ..common.perf_counters import HIST_LE
from ..common.tracer import TRACER
from .messages import MQoSSettings
from .module import MgrModule, register_module

#: stages whose p99 the controller watches (names match the OSD's
#: stage_* histograms / tracer.OP_STAGES verbatim)
WATCHED_STAGES = ("stage_queue", "stage_encode")

#: background mClock classes the controller OBSERVES (cephheal: their
#: depth/served/wait feed the loop's telemetry and export, but plan()
#: never writes them — the static floors stay protected, docs/qos.md)
BACKGROUND_CLASSES = ("background_recovery", "background_scrub")


def hist_quantile(buckets, q: float = 0.99) -> float | None:
    """Quantile (seconds, upper bucket bound) of one log2 bucket-count
    vector — used on windowed bucket DELTAS, so the answer describes
    this tick's samples, not all of history.  None when empty."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= rank:
            return HIST_LE[i] if i < len(HIST_LE) else HIST_LE[-1] * 2.0
    return HIST_LE[-1] * 2.0


def hist_delta(cur: dict | None, prev: dict | None) -> list[int]:
    """Per-bucket delta of two histogram dumps; a counter reset (daemon
    restart) clamps to the current snapshot instead of going negative."""
    cb = list((cur or {}).get("buckets") or [])
    pb = list((prev or {}).get("buckets") or [])
    if not cb:
        return []
    if len(pb) != len(cb):
        return cb
    out = [c - p for c, p in zip(cb, pb)]
    if any(d < 0 for d in out):
        return cb
    return out


@dataclass(frozen=True)
class QoSClamps:
    """Declared bounds every decision stays inside (the options)."""

    window_min_ms: float = 0.5
    window_max_ms: float = 20.0
    stripes_min: int = 8
    stripes_max: int = 256
    queue_p99_target_ms: float = 50.0
    # hysteresis (cephstorm): grow the window back only once queue p99
    # has recovered BELOW this fraction of the target — backing off at
    # `> target` while regrowing at `<= target` limit-cycled the window
    # between the two rules every other tick under steady load
    queue_p99_recover_frac: float = 0.8
    bully_factor: float = 4.0
    heavy_weight: float = 5.0
    victim_reservation: float = 40.0


@dataclass
class QoSObservation:
    """One tick's inputs (synthesizable in tests without a cluster)."""

    window_ms: float
    max_stripes: int
    queue_p99_ms: float | None = None
    encode_p99_ms: float | None = None
    op_rate: float = 0.0                 # aggregate client writes/s
    stripes_per_flush: float | None = None
    per_client_rates: dict = field(default_factory=dict)  # key -> ops/s
    # cephheal (observe-only): {class: {depth, rate, wait_p99_ms}} for
    # BACKGROUND_CLASSES — plan() must never retune these
    background: dict = field(default_factory=dict)


class QoSController:
    """The pure planner: observation -> clamped decision.  Deterministic
    and state-free so tests drive it on synthetic series; repeated
    application under a FIXED observation converges (window approaches
    the arrival-matched ideal geometrically; overload pins the floor)."""

    def __init__(self, clamps: QoSClamps):
        self.clamps = clamps

    def _clamp_window(self, w: float) -> float:
        c = self.clamps
        return min(c.window_max_ms, max(c.window_min_ms, w))

    def plan(self, obs: QoSObservation) -> dict:
        c = self.clamps
        reasons: list[str] = []
        # -- coalescing window ------------------------------------------
        # ideal: long enough that a half-full batch accumulates at the
        # observed arrival rate (arXiv:1709.05365 — batch formation is
        # the queueing structure that matters), clamped.
        window = self._clamp_window(obs.window_ms)
        if obs.queue_p99_ms is not None \
                and obs.queue_p99_ms > c.queue_p99_target_ms:
            # queueing over target: multiplicative backoff beats any
            # model — shrink first, re-observe next tick
            window = self._clamp_window(obs.window_ms * 0.7)
            reasons.append(
                f"queue_p99 {obs.queue_p99_ms:.1f}ms > target "
                f"{c.queue_p99_target_ms:.1f}ms: window -> "
                f"{window:.2f}ms")
        elif obs.op_rate > 0 and (
                obs.queue_p99_ms is None
                or obs.queue_p99_ms
                <= c.queue_p99_recover_frac * c.queue_p99_target_ms):
            # grow only once p99 has RECOVERED below the hysteresis
            # band, not merely dipped under the backoff threshold —
            # the storm's oscillation invariant pinned the flip-flop
            # this band prevents (seed in tests/test_storm.py)
            ideal = self._clamp_window(
                (obs.max_stripes / 2.0) / obs.op_rate * 1e3)
            window = self._clamp_window(
                obs.window_ms + 0.5 * (ideal - obs.window_ms))
            if abs(window - obs.window_ms) > 1e-3:
                reasons.append(
                    f"arrivals {obs.op_rate:.0f}/s: window -> "
                    f"{window:.2f}ms (ideal {ideal:.2f}ms)")
        # -- stripe cap -------------------------------------------------
        stripes = min(c.stripes_max, max(c.stripes_min, obs.max_stripes))
        if obs.encode_p99_ms is not None \
                and obs.encode_p99_ms > 2 * c.queue_p99_target_ms:
            stripes = max(c.stripes_min, stripes // 2)
            reasons.append(
                f"encode_p99 {obs.encode_p99_ms:.1f}ms: stripes -> "
                f"{stripes}")
        elif (obs.stripes_per_flush is not None
                and obs.stripes_per_flush >= 0.9 * stripes):
            grown = min(c.stripes_max, stripes * 2)
            if grown != stripes:
                reasons.append(
                    f"flushes saturate {stripes}-stripe cap: -> {grown}")
            stripes = grown
        # -- per-client classes -----------------------------------------
        classes: dict[str, tuple] = {}
        rates = {k: v for k, v in obs.per_client_rates.items() if v > 0}
        if len(rates) >= 2:
            vals = sorted(rates.values())
            # LOWER-middle median: with few clients the upper middle is
            # the bully itself (2 clients -> med == max, nothing is ever
            # heavy); the lower middle is the light-tenant baseline
            med = vals[(len(vals) - 1) // 2]
            heavies = [k for k, v in rates.items()
                       if v > c.bully_factor * max(med, 1.0)]
            if heavies:
                for k in rates:
                    if k in heavies:
                        # low WEIGHT, no hard limit: the scheduler
                        # stays work-conserving (aggregate survives),
                        # the bully just loses ties under contention
                        classes[k] = (0.0, c.heavy_weight, 0.0)
                    else:
                        classes[k] = (c.victim_reservation, 10.0, 0.0)
                reasons.append(
                    f"heavy clients {sorted(heavies)}: weight "
                    f"{c.heavy_weight}, victims reserved "
                    f"{c.victim_reservation}/s")
        return {
            "window_ms": round(window, 3),
            "max_stripes": int(stripes),
            "classes": classes,
            "reasons": reasons,
        }


@register_module
class QoSModule(MgrModule):
    """The controller loop host (module docstring)."""

    NAME = "qos"

    def __init__(self, mgr):
        super().__init__(mgr)
        cct = self.cct
        # controller-owned targets, seeded from this process's declared
        # defaults; after the first push the controller's view IS the
        # cluster's (every OSD applied the same epoch)
        self._window_ms = float(cct.conf.get("ec_batch_window_ms"))
        self._max_stripes = int(cct.conf.get("ec_batch_max_stripes"))
        # epoch base = wall-clock seconds: a RESTARTED mgr must mint
        # epochs above the dead one's high-water mark or the OSDs'
        # monotonic guard silently drops every push from the new
        # controller (a pure 0-based counter resets on failover)
        self._epoch = int(time.time())  # noqa: CL11 — failover epoch floor MUST be wall time (see comment above)
        self._lock = make_lock("mgr::qos")
        # previous-tick snapshots for windowed deltas
        self._prev_hists: dict[tuple[str, str], dict] = {}
        self._prev_client_ops: dict[tuple[str, str], float] = {}
        self._prev_client_ts: float | None = None
        # cephheal: background-class served counters (windowed rates)
        self._prev_bg_served: dict[str, float] = {}
        self._prev_bg_ts: float | None = None
        self._stats = {"ticks": 0, "retunes": 0, "pushes": 0,
                       "push_errors": 0, "heavy_clients": 0}
        self._last = {"queue_p99_ms": None, "encode_p99_ms": None,
                      "op_rate": 0.0, "background": {}, "reasons": []}
        self.decisions: list[dict] = []  # bounded ring, introspection

    def _clamps(self) -> QoSClamps:
        cct = self.cct
        return QoSClamps(
            window_min_ms=float(cct.conf.get("mgr_qos_window_min_ms")),
            window_max_ms=float(cct.conf.get("mgr_qos_window_max_ms")),
            stripes_min=int(cct.conf.get("mgr_qos_stripes_min")),
            stripes_max=int(cct.conf.get("mgr_qos_stripes_max")),
            queue_p99_target_ms=float(
                cct.conf.get("mgr_qos_queue_p99_target_ms")),
            queue_p99_recover_frac=float(
                cct.conf.get("mgr_qos_queue_p99_recover_frac")),
            bully_factor=float(cct.conf.get("mgr_qos_bully_factor")),
            heavy_weight=float(cct.conf.get("mgr_qos_heavy_weight")),
            victim_reservation=float(
                cct.conf.get("mgr_qos_victim_reservation")),
        )

    # -- observe ------------------------------------------------------------
    def observe(self) -> QoSObservation:
        stale = float(self.cct.conf.get("mgr_stale_report_age"))
        reports = self.mgr.latest_reports()
        # stage p99s: windowed bucket deltas aggregated across OSDs
        agg: dict[str, list[int]] = {}
        for daemon, subsystems in reports.items():
            if not daemon.startswith("osd."):
                continue
            osd = (subsystems or {}).get("osd") or {}
            for stage in WATCHED_STAGES:
                cur = osd.get(stage)
                if not isinstance(cur, dict) or "buckets" not in cur:
                    continue
                prev = self._prev_hists.get((daemon, stage))
                self._prev_hists[(daemon, stage)] = cur
                if prev is None:
                    continue  # first sighting primes — booking a
                    # long-running OSD's whole cumulative histogram as
                    # one tick's samples would fake a p99 blowout
                delta = hist_delta(cur, prev)
                if delta:
                    tot = agg.setdefault(stage, [0] * len(delta))
                    if len(tot) == len(delta):
                        for i, d in enumerate(delta):
                            tot[i] += d
        q99 = hist_quantile(agg.get("stage_queue", ()))
        e99 = hist_quantile(agg.get("stage_encode", ()))
        # rates from the metrics-history store (the PR-11 substrate)
        hist = self.mgr.metrics_history
        op_rate = sum((hist.rate("osd.op_w", max_age=stale) or {}).values())
        sr = sum((hist.rate("osd.ec_batch_stripes",
                            max_age=stale) or {}).values())
        fr = sum((hist.rate("osd.ec_batch_flushes",
                            max_age=stale) or {}).values())
        spf = (sr / fr) if fr > 0 else None
        return QoSObservation(
            window_ms=self._window_ms,
            max_stripes=self._max_stripes,
            queue_p99_ms=None if q99 is None else q99 * 1e3,
            encode_p99_ms=None if e99 is None else e99 * 1e3,
            op_rate=op_rate,
            stripes_per_flush=spf,
            per_client_rates=self._client_rates(reports),
            background=self._background_state(reports),
        )

    def _background_state(self, reports: dict) -> dict:
        """Aggregate the background_recovery/background_scrub mClock
        rows (the ceph_mclock_*{qclass} SchedulerPerf series) across
        OSDs: queue depth, served-op rate (windowed cumulative-counter
        delta), and wait p99 (windowed histogram bucket delta — the
        same discipline as the stage p99s).  Observe-only: the first
        half of the ROADMAP QoS residual; feeding them into plan()
        stays future work and the background floors stay
        controller-unwritable."""
        now = time.monotonic()
        out: dict[str, dict] = {}
        agg_wait: dict[str, list[int]] = {}
        depth: dict[str, int] = {}
        served: dict[str, float] = {}
        for daemon, subsystems in reports.items():
            if not daemon.startswith("osd."):
                continue
            rows = (((subsystems or {}).get("mclock") or {})
                    .get("per_class") or {}).get("rows") or []
            for row in rows:
                cls = (row.get("labels") or {}).get("qclass")
                if cls not in BACKGROUND_CLASSES:
                    continue
                depth[cls] = depth.get(cls, 0) + int(
                    row.get("depth") or 0)
                served[cls] = served.get(cls, 0.0) + float(
                    row.get("served") or 0)
                wait = row.get("wait")
                if isinstance(wait, dict) and "buckets" in wait:
                    key = (daemon, f"mclock.{cls}.wait")
                    prev = self._prev_hists.get(key)
                    self._prev_hists[key] = wait
                    if prev is None:
                        continue  # first sighting primes
                    delta = hist_delta(wait, prev)
                    if delta:
                        tot = agg_wait.setdefault(cls, [0] * len(delta))
                        if len(tot) == len(delta):
                            for i, d in enumerate(delta):
                                tot[i] += d
        prev_ts = self._prev_bg_ts
        prev_served_map = self._prev_bg_served
        self._prev_bg_ts = now
        # the prev map is replaced WHOLESALE (the _client_rates rule):
        # a class absent this tick — every report stale during an OSD
        # outage — re-primes on return instead of booking the whole
        # gap's served delta against one tick interval
        self._prev_bg_served = {
            cls: served.get(cls, 0.0)
            for cls in BACKGROUND_CLASSES
            if cls in depth or cls in served
        }
        for cls in BACKGROUND_CLASSES:
            if cls not in depth and cls not in served:
                continue
            rate = None
            prev_served = prev_served_map.get(cls)
            if prev_served is not None and prev_ts is not None \
                    and now > prev_ts:
                rate = max(0.0, (served.get(cls, 0.0) - prev_served)
                           / (now - prev_ts))
            p99 = hist_quantile(agg_wait.get(cls, ()))
            out[cls] = {
                "depth": depth.get(cls, 0),
                "rate": None if rate is None else round(rate, 3),
                "wait_p99_ms": None if p99 is None else p99 * 1e3,
            }
        return out

    def _client_rates(self, reports: dict) -> dict:
        """Per-(client,pool) write-op rates from the cephmeter labeled
        accounting rows, windowed against the previous tick (cumulative
        row counters; a restart's negative delta clamps to 0).  Keys
        are the "client/pool" strings the OSD's dynamic mClock classes
        use, so plan() output maps straight onto scheduler classes."""
        now = time.monotonic()
        totals: dict[tuple[str, str], float] = {}
        for daemon, subsystems in reports.items():
            if not daemon.startswith("osd."):
                continue
            tab = ((subsystems or {}).get("client_io") or {})
            rows = (tab.get("per_client") or {}).get("rows") or []
            for row in rows:
                labels = row.get("labels") or {}
                client = labels.get("client")
                pool = labels.get("pool")
                if not client or client.startswith("_"):
                    continue
                key = (str(client), str(pool))
                totals[key] = totals.get(key, 0.0) + float(
                    row.get("ops_w") or 0)
        rates: dict[str, float] = {}
        prev_ts = self._prev_client_ts
        if prev_ts is not None and now > prev_ts:
            dt = now - prev_ts
            for key, tot in totals.items():
                prev = self._prev_client_ops.get(key)
                if prev is None:
                    continue  # first sighting primes; a client whose
                    # row was LRU-folded and returned would otherwise
                    # book its whole cumulative history as one tick
                d = tot - prev
                if d > 0:
                    rates[f"{key[0]}/{key[1]}"] = d / dt
        self._prev_client_ops = totals
        self._prev_client_ts = now
        return rates

    # -- one tick ------------------------------------------------------------
    def tick(self) -> dict:
        obs = self.observe()
        decision = QoSController(self._clamps()).plan(obs)
        retuned = (abs(decision["window_ms"] - self._window_ms) > 1e-3
                   or decision["max_stripes"] != self._max_stripes
                   or bool(decision["classes"]))
        with self._lock:
            self._stats["ticks"] += 1
            self._stats["heavy_clients"] = sum(
                1 for rwl in decision["classes"].values() if not rwl[0])
            self._last = {"queue_p99_ms": obs.queue_p99_ms,
                          "encode_p99_ms": obs.encode_p99_ms,
                          "op_rate": obs.op_rate,
                          "background": obs.background,
                          "reasons": decision["reasons"]}
            self.decisions.append(
                {"ts": time.monotonic(), **decision})
            del self.decisions[:-128]
        pushed = 0
        if bool(self.cct.conf.get("mgr_qos_active")):
            pushed = self.push(decision)
        if pushed:
            # commit the plan into controller state ONLY once it is on
            # the OSDs: in observe-only mode (or with every send
            # failing) compounding decisions on hypothetical state
            # would geometrically drift the window to a clamp while
            # the cluster never changed — then the first real push
            # would slam the drifted value instead of tuning from the
            # actual current one
            with self._lock:
                self._window_ms = decision["window_ms"]
                self._max_stripes = decision["max_stripes"]
                if retuned:
                    self._stats["retunes"] += 1
            if retuned:
                TRACER.tracepoint(
                    "qos", "retune", entity="mgr",
                    window_ms=decision["window_ms"],
                    max_stripes=decision["max_stripes"],
                    classes=len(decision["classes"]),
                    queue_p99_ms=obs.queue_p99_ms,
                    encode_p99_ms=obs.encode_p99_ms,
                    op_rate=round(obs.op_rate, 1),
                    reasons="; ".join(decision["reasons"]))
        self.export()
        return decision

    # -- push ----------------------------------------------------------------
    def push(self, decision: dict) -> int:
        """One MQoSSettings per reporting OSD over its report conn."""
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
        msg_options = {
            "ec_batch_window_ms": decision["window_ms"],
            "ec_batch_max_stripes": decision["max_stripes"],
        }
        classes = {name: list(rwl)
                   for name, rwl in decision["classes"].items()}
        sent = 0
        for daemon, conn in sorted(
                self.mgr.report_conns(prefix="osd.").items()):
            try:
                conn.send_message(MQoSSettings(
                    qos_epoch=epoch, options=msg_options,
                    classes=classes))
                sent += 1
            except (OSError, ConnectionError) as e:
                with self._lock:
                    self._stats["push_errors"] += 1
                self.cct.dout("mgr", 3,
                              f"qos push to {daemon} failed: {e!r}")
        with self._lock:
            self._stats["pushes"] += sent
        return sent

    # -- export ---------------------------------------------------------------
    def export(self) -> None:
        """Render the controller's state as ceph_qos_* series through
        the mgr's own report sink (prometheus + metrics_history)."""
        with self._lock:
            last = dict(self._last)
            bg = last.get("background") or {}
            rec = bg.get("background_recovery") or {}
            scr = bg.get("background_scrub") or {}
            counters = {"qos": {
                # cephheal (observe-only): the background classes'
                # scheduler state as first-class controller telemetry
                "recovery_depth": rec.get("depth") or 0,
                "recovery_served_rate": rec.get("rate") or 0.0,
                "recovery_wait_p99_ms": rec.get("wait_p99_ms") or 0.0,
                "scrub_depth": scr.get("depth") or 0,
                "scrub_served_rate": scr.get("rate") or 0.0,
                "scrub_wait_p99_ms": scr.get("wait_p99_ms") or 0.0,
                "window_ms": self._window_ms,
                "max_stripes": self._max_stripes,
                "ticks": self._stats["ticks"],
                "retunes": self._stats["retunes"],
                "pushes": self._stats["pushes"],
                "push_errors": self._stats["push_errors"],
                "heavy_clients": self._stats["heavy_clients"],
                "qos_epoch": self._epoch,
                "queue_p99_ms": last["queue_p99_ms"] or 0.0,
                "encode_p99_ms": last["encode_p99_ms"] or 0.0,
                "op_rate": round(last["op_rate"], 3),
                "active": int(bool(self.cct.conf.get("mgr_qos_active"))),
            }}
        self.mgr.ingest_local_report("mgr", counters, schema=_QOS_SCHEMA)

    def status(self) -> dict:
        with self._lock:
            return {
                "active": bool(self.cct.conf.get("mgr_qos_active")),
                "window_ms": self._window_ms,
                "max_stripes": self._max_stripes,
                "qos_epoch": self._epoch,
                "stats": dict(self._stats),
                "last": dict(self._last),
            }

    def serve(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(timeout=float(
                self.cct.conf.get("mgr_qos_interval")))
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception as e:
                # one bad tick (a daemon mid-restart, a torn report)
                # must not kill the loop
                self.cct.dout("mgr", 1, f"qos tick failed: {e!r}")


_QOS_SCHEMA = {"qos": {
    "window_ms": {"type": "gauge",
                  "description": "controller's current "
                                 "ec_batch_window_ms target"},
    "max_stripes": {"type": "gauge",
                    "description": "controller's current "
                                   "ec_batch_max_stripes target"},
    "ticks": {"type": "u64", "description": "controller ticks run"},
    "retunes": {"type": "u64",
                "description": "ticks whose decision changed a knob or "
                               "class"},
    "pushes": {"type": "u64",
               "description": "MQoSSettings successfully sent to OSDs"},
    "push_errors": {"type": "u64",
                    "description": "failed MQoSSettings sends"},
    "heavy_clients": {"type": "gauge",
                      "description": "clients currently classed heavy "
                                     "(low mClock weight)"},
    "qos_epoch": {"type": "gauge",
                  "description": "monotonic settings epoch stamped on "
                                 "pushes"},
    "queue_p99_ms": {"type": "gauge",
                     "description": "observed stage_queue p99 this tick "
                                    "(windowed bucket deltas)"},
    "encode_p99_ms": {"type": "gauge",
                      "description": "observed stage_encode p99 this "
                                     "tick"},
    "op_rate": {"type": "gauge",
                "description": "aggregate client write ops/s observed"},
    "active": {"type": "gauge",
               "description": "1 = controller pushes settings; 0 = "
                              "observe/export only"},
    "recovery_depth": {
        "type": "gauge",
        "description": "background_recovery mClock queue depth summed "
                       "across OSDs (cephheal observe-only)"},
    "recovery_served_rate": {
        "type": "gauge",
        "description": "background_recovery ops dequeued per second "
                       "(windowed served-counter delta)"},
    "recovery_wait_p99_ms": {
        "type": "gauge",
        "description": "background_recovery enqueue->dequeue wait p99 "
                       "this tick (windowed bucket deltas)"},
    "scrub_depth": {
        "type": "gauge",
        "description": "background_scrub mClock queue depth summed "
                       "across OSDs"},
    "scrub_served_rate": {
        "type": "gauge",
        "description": "background_scrub ops dequeued per second"},
    "scrub_wait_p99_ms": {
        "type": "gauge",
        "description": "background_scrub enqueue->dequeue wait p99 "
                       "this tick"},
}}
