"""cephdev — per-kernel telemetry registry + TPU backend health sentinel
(reference: the mon `DEVICE_HEALTH*`/`SLOW_OPS` device-health scraping of
src/mgr/DaemonHealthMetricCollector.cc + mgr/devicehealth, applied to the
accelerator under the data plane; arXiv:1709.05365's finding that a
degraded device path changes the whole write path's queueing behavior —
so degradation must be a first-class, alertable cluster state, not a
bench footnote).

Two layers, both process-wide (kernel dispatch is per-process, like the
`ec_kernel` override and the cephtrace TRACER):

- **KernelTelemetry** (``TELEMETRY``): one record per kernel entry point
  (``gf_apply``, ``gf_xor``, ``stream_encode``, ``ec_batch_flush``,
  ``crush_do_rule_batch``) — invocation counts, compile-vs-execute wall
  time as log2 histograms (the PR-9 ``TYPE_HISTOGRAM``), bytes in/out,
  achieved GiB/s where the call is a true sync point, and the backend
  that served each call.  Storage IS a shared
  :class:`~ceph_tpu.common.perf_counters.PerfCounters` ("kernel"), so the
  numbers flow through the existing ``perf dump`` -> MMgrReport ->
  prometheus exporter pipeline (HELP text from the PR-9 schema path)
  with zero new wire plumbing.  Fallback latches (the reference
  codec's one-shot Pallas->XLA downgrade; the port has one path per
  device and records none) are recorded with reason + timestamp and
  feed the ``KERNEL_FALLBACK_LATCHED`` health check.  Disabled, every
  instrumented dispatch pays ONE attribute check (measured in PERF.md).

- **BackendSentinel** (``SENTINEL``): a probe thread (constructor-
  injected :class:`SentinelPolicy`, per the ROADMAP's topology-injection
  direction) that checks backend liveness on a FAST timeout — the probe
  runs on a disposable worker thread so a wedged backend hangs the
  worker, never the sentinel or any caller — and latches a
  cluster-visible ``degraded`` state instead of wedging callers.  In
  the port the latch switches the device pool (``ops/device_pool.py``)
  and the read batcher's coalescing off: batching changes, the device
  does not — nothing routes work to the CPU or to a kernel's plain
  version.  The state clears itself when a later probe answers.  Surfaced as
  the mon ``TPU_BACKEND_DEGRADED`` health check (OSD ``_mgr_report`` ->
  mgr status digest -> mon ``_status``), the ``dump_kernel_telemetry``
  admin command, and ``bench.py``'s wedge reporting.

CI / tests force states without hardware: the ``CEPH_TPU_SENTINEL_STATE``
env var (``degraded[:reason]`` / ``ok``) short-circuits the default
probe, and the ``tpu.backend.probe`` failpoint (``error`` arm) fails it
through the registry.  See docs/observability.md.
"""
from __future__ import annotations

import os
import sys
import threading
import time

from .failpoint import failpoint
from .lockdep import make_lock
from .perf_counters import PerfCounters

#: bounded latch/sentinel event log (rare transitions; 256 is weeks)
_MAX_EVENTS = 256


class _KernelStats:
    """Rich per-kernel record behind the PerfCounters mirror (backends
    per call, last-call provenance, achieved GiB/s, host-copy volume)."""

    __slots__ = ("calls", "bytes_in", "bytes_out", "exec_seconds",
                 "compiles", "backends", "last_backend", "last_ts",
                 "last_gibps", "host_copy_bytes", "sync_points")

    def __init__(self):
        self.calls = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.exec_seconds = 0.0
        self.compiles = 0
        self.backends: dict[str, int] = {}
        self.last_backend: str | None = None
        self.last_ts: float | None = None
        self.last_gibps: float | None = None
        # cephdma: bytes this kernel's dispatch seam copied through host
        # memory (staging packs, host->device commits, device->host
        # materializations) and how many of its calls were sync points
        # (blocked on a device round trip) — the pair the device-pool
        # control-vs-pool audit compares (docs/write_path.md)
        self.host_copy_bytes = 0
        self.sync_points = 0

    def to_dict(self) -> dict:
        return {
            "calls": self.calls,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "exec_seconds": self.exec_seconds,
            "compiles": self.compiles,
            "backends": dict(self.backends),
            "last_backend": self.last_backend,
            "last_ts": self.last_ts,
            "last_gibps": self.last_gibps,
            "host_copy_bytes": self.host_copy_bytes,
            "sync_points": self.sync_points,
        }


class KernelTelemetry:
    """Process-wide per-kernel dispatch telemetry (see module docstring).

    The hot-path contract: every instrumented seam does

        if TELEMETRY.enabled:
            ...time + record...

    so disabled telemetry costs one attribute check per dispatch.
    """

    def __init__(self):
        self.enabled = True
        self._lock = make_lock("telemetry::kernels")
        #: shared PerfCounters: daemons add this one object to their
        #: cct.perf so kernel series ride the existing report pipeline
        self.perf = PerfCounters("kernel")
        self._kernels: dict[str, _KernelStats] = {}
        self._declared: set[str] = set()
        self._compile_keys: set[tuple] = set()
        #: kernel -> active fallback latch record (reason, ts, from, to)
        self._fallbacks: dict[str, dict] = {}
        self._events: list[dict] = []

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    # -- recording ---------------------------------------------------------
    def _declare_locked(self, kernel: str) -> _KernelStats:
        ks = self._kernels.get(kernel)
        if ks is None:
            ks = self._kernels[kernel] = _KernelStats()
        if kernel not in self._declared:
            self._declared.add(kernel)
            self.perf._add(f"{kernel}_calls", "u64",
                           f"{kernel} kernel invocations")
            self.perf._add(f"{kernel}_bytes_in", "u64",
                           f"{kernel} input bytes dispatched")
            self.perf._add(f"{kernel}_bytes_out", "u64",
                           f"{kernel} output bytes produced")
            self.perf._add(f"{kernel}_compile", "histogram",
                           f"{kernel} first-shape (compile) wall time")
            self.perf._add(f"{kernel}_execute", "histogram",
                           f"{kernel} steady-state dispatch wall time")
            self.perf._add(f"{kernel}_gibps", "gauge",
                           f"{kernel} last achieved GiB/s (sync calls)")
            self.perf._add(f"{kernel}_host_copy_bytes", "u64",
                           f"{kernel} bytes copied through host memory "
                           f"(staging packs + host<->device transfers "
                           f"this seam performed)")
            self.perf._add(f"{kernel}_sync_points", "u64",
                           f"{kernel} calls that blocked on a device "
                           f"round trip (the deliberate sync points)")
        return ks

    def first_call(self, key: tuple) -> bool:
        """True the first time `key` (kernel + shapes + backend) is seen —
        the compile-vs-execute histogram discriminator (jit recompiles
        per shape, so a fresh shape's wall time includes the compile)."""
        with self._lock:
            if key in self._compile_keys:
                return False
            self._compile_keys.add(key)
            return True

    def record(self, kernel: str, backend: str, seconds: float,
               bytes_in: int = 0, bytes_out: int = 0,
               compiled: bool = False, synced: bool = False,
               host_copy_bytes: int = 0) -> None:
        """One kernel dispatch.  `synced` marks calls whose wall time
        covers a device round-trip (result fetched) — only those yield
        an honest achieved-GiB/s sample; async dispatches record wall
        time only (JAX queues the launch and returns).
        `host_copy_bytes` counts the bytes THIS seam copied through host
        memory during the call (staging packs, host->device commits,
        device->host materializations) — each seam counts only its own
        copies, so summing the counters across kernels stays honest."""
        if not self.enabled:
            return
        now = time.time()
        gibps = None
        if synced and seconds > 0 and bytes_in:
            gibps = bytes_in / seconds / 2**30
        with self._lock:
            ks = self._declare_locked(kernel)
            ks.calls += 1
            ks.bytes_in += int(bytes_in)
            ks.bytes_out += int(bytes_out)
            ks.exec_seconds += seconds
            ks.backends[backend] = ks.backends.get(backend, 0) + 1
            ks.last_backend = backend
            ks.last_ts = now
            if compiled:
                ks.compiles += 1
            if gibps is not None:
                ks.last_gibps = gibps
            ks.host_copy_bytes += int(host_copy_bytes)
            if synced:
                ks.sync_points += 1
        self.perf.inc(f"{kernel}_calls")
        if bytes_in:
            self.perf.inc(f"{kernel}_bytes_in", int(bytes_in))
        if bytes_out:
            self.perf.inc(f"{kernel}_bytes_out", int(bytes_out))
        self.perf.hinc(f"{kernel}_compile" if compiled
                       else f"{kernel}_execute", seconds)
        if gibps is not None:
            self.perf.set(f"{kernel}_gibps", gibps)
        if host_copy_bytes:
            self.perf.inc(f"{kernel}_host_copy_bytes", int(host_copy_bytes))
        if synced:
            self.perf.inc(f"{kernel}_sync_points")

    # -- device-pool mirror (ops/device_pool.py) ---------------------------
    _POOL_COUNTERS = ("hits", "misses", "evictions", "donations")

    def record_pool(self, hits: int = 0, misses: int = 0,
                    evictions: int = 0, donations: int = 0,
                    resident_bytes: int | None = None) -> None:
        """Mirror device-pool stat deltas into the shared PerfCounters so
        `device_pool_*` series ride the same perf dump -> MMgrReport ->
        prometheus pipeline as the kernel records (the pool keeps its own
        authoritative totals; this is the export seam)."""
        if not self.enabled:
            return
        with self._lock:
            if "device_pool_hits" not in self._declared:
                self._declared.add("device_pool_hits")
                for name in self._POOL_COUNTERS:
                    self.perf._add(
                        f"device_pool_{name}", "u64",
                        f"device stripe pool {name} "
                        f"(ops/device_pool.py; docs/write_path.md)")
                self.perf._add(
                    "device_pool_resident_bytes", "gauge",
                    "device stripe pool free-list residency in bytes")
        for name, v in (("hits", hits), ("misses", misses),
                        ("evictions", evictions), ("donations", donations)):
            if v:
                self.perf.inc(f"device_pool_{name}", int(v))
        if resident_bytes is not None:
            self.perf.set("device_pool_resident_bytes", int(resident_bytes))

    # -- fallback latches + event log --------------------------------------
    def record_event(self, kind: str, **fields) -> None:
        """Append one transition event (fallback latch/clear, sentinel
        degrade/recover) to the bounded log; always on — transitions are
        rare and ARE the alertable signal, so they bypass `enabled`."""
        with self._lock:
            self._events.append({"ts": time.time(), "kind": kind, **fields})
            if len(self._events) > _MAX_EVENTS:
                del self._events[: _MAX_EVENTS // 4]

    def record_fallback(self, kernel: str, reason: str,
                        frm: str = "pallas", to: str = "xla") -> None:
        """A kernel latched a fallback backend (the codec's one-shot
        Pallas->XLA downgrade).  Feeds KERNEL_FALLBACK_LATCHED."""
        rec = {"kernel": kernel, "reason": reason, "from": frm, "to": to,
               "ts": time.time()}
        with self._lock:
            self._fallbacks[kernel] = rec
        self.record_event("fallback_latched", **rec)

    def clear_fallback(self, kernel: str | None = None) -> bool:
        """Drop active fallback latches (kernel=None: all).  Returns
        True if anything was latched.  The bitplane module's
        `clear_fallback_latch` composes this with its own un-latch."""
        with self._lock:
            if kernel is None:
                cleared = sorted(self._fallbacks)
                self._fallbacks.clear()
            else:
                cleared = [kernel] if self._fallbacks.pop(kernel, None) \
                    else []
        for k in cleared:
            self.record_event("fallback_cleared", kernel=k)
        return bool(cleared)

    def fallback_latched(self) -> dict:
        """{kernel: latch record} for every active latch ({} = none)."""
        with self._lock:
            return {k: dict(v) for k, v in self._fallbacks.items()}

    def events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    # -- introspection -----------------------------------------------------
    def dump(self) -> dict:
        with self._lock:
            kernels = {k: v.to_dict() for k, v in self._kernels.items()}
        return kernels

    def summary(self, kernels=None) -> dict:
        """Compact {kernel: {calls, backends, last_backend, last_gibps}}
        (bench.py attaches this to phase results as silicon provenance)."""
        out = {}
        with self._lock:
            for k, v in self._kernels.items():
                if kernels is not None and k not in kernels:
                    continue
                out[k] = {"calls": v.calls, "backends": dict(v.backends),
                          "last_backend": v.last_backend,
                          "last_gibps": v.last_gibps}
        return out


TELEMETRY = KernelTelemetry()


class BackendDevicePerf:
    """PerfCounters duck type exporting the sentinel's per-device probe
    rows as ``ceph_backend_device_*{device}`` labeled series (cephplace
    satellite — groundwork for the ROADMAP mesh-shrink item: a sick
    chip shows up as its OWN row going unhealthy, not just a process-
    wide degraded flag).  Daemons add the singleton to their cct.perf
    next to TELEMETRY.perf; the rows come live from the sentinel at
    dump time, so there is no write path to race."""

    def __init__(self):
        self.name = "backend"

    def dump(self) -> dict:
        rows = [
            {"labels": {"device": d["device"]},
             "device_ok": int(bool(d.get("ok"))),
             "device_probe_ms": round(float(d.get("latency_ms") or 0.0),
                                      3)}
            for d in SENTINEL.devices()
        ]
        return {
            "per_device": {"__labeled__": True, "rows": rows},
            "devices_seen": len(rows),
        }

    def schema(self) -> dict:
        return {
            "per_device": {
                "type": "labeled",
                "description": "per-accelerator-device probe rows from "
                               "the backend sentinel "
                               "(docs/observability.md)"},
            "device_ok": {
                "type": "gauge",
                "description": "1 = the last sentinel probe reached "
                               "this CUDA device; 0 = it failed or the "
                               "backend probe as a whole is failing"},
            "device_probe_ms": {
                "type": "gauge",
                "description": "last per-device probe round-trip "
                               "latency (copy + synchronize) in ms"},
            "devices_seen": {
                "type": "gauge",
                "description": "devices the sentinel has probed"},
        }


DEVICE_PERF = BackendDevicePerf()


# -- backend health sentinel -----------------------------------------------

def default_probe() -> str:
    """Backend liveness probe: returns the platform string or raises.

    Runs on a DISPOSABLE worker thread (a wedged backend hangs the
    worker, not the sentinel).  Overridable without hardware:

    - failpoint ``tpu.backend.probe`` (``error`` arm) fails it through
      the registry;
    - ``CEPH_TPU_SENTINEL_STATE=degraded[:reason]`` fails it,
      ``=ok`` passes it — both WITHOUT touching the card (the CI simulated
      wedge; bench.py's watchdog probe honors the same variable).
    """
    failpoint("tpu.backend.probe")
    forced = os.environ.get("CEPH_TPU_SENTINEL_STATE", "")
    if forced:
        state, _, reason = forced.partition(":")
        if state == "degraded":
            raise RuntimeError(
                reason or "forced degraded (CEPH_TPU_SENTINEL_STATE)")
        return "forced-ok"
    # the CUDA runtime's device query is the ambient touch that a wedged
    # card hangs on — which is exactly what this disposable worker is for
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def _forced_device_rows(ok: bool, reason: str | None) -> list[dict]:
    """The ONE synthesized-row shape every forced/pinned sentinel path
    emits (env override + runtime force pin) — exporter consumers see
    the same fields either way."""
    return [{"device": "forced:0", "platform": "forced", "ok": ok,
             "latency_ms": 0.0, "error": None if ok else reason}]


def probe_device_rows() -> list[dict]:
    """Per-device probe rows: one entry per CUDA device with verdict +
    round-trip latency (a tiny host-to-device copy followed by
    ``torch.cuda.synchronize``), or one ``cpu:0`` row on a host with no
    card, where the daemons run on the CPU (as jax lists its CPU devices
    when it has no accelerator).  Runs INSIDE the sentinel's disposable
    probe worker — a wedged device hangs the worker, never a caller.
    The ``CEPH_TPU_SENTINEL_STATE`` override synthesizes rows without
    touching the card (the CI simulated wedge)."""
    forced = os.environ.get("CEPH_TPU_SENTINEL_STATE", "")
    if forced:
        state, _, reason = forced.partition(":")
        ok = state != "degraded"
        return _forced_device_rows(ok, reason or (
            "forced degraded (CEPH_TPU_SENTINEL_STATE)"))
    import torch

    rows = []
    n_cuda = torch.cuda.device_count()
    for i in range(max(n_cuda, 1)):
        t0 = time.perf_counter()
        try:
            if n_cuda:
                torch.zeros(8, dtype=torch.uint8).to(f"cuda:{i}")
                torch.cuda.synchronize(i)
            else:
                torch.zeros(8, dtype=torch.uint8).clone()
            ok, err = True, None
        except Exception as e:  # one sick device must not hide the rest
            ok, err = False, f"{type(e).__name__}: {e}"
        rows.append({
            "device": f"cuda:{i}" if n_cuda else "cpu:0",
            "platform": "cuda" if n_cuda else "cpu",
            "ok": ok,
            "latency_ms": (time.perf_counter() - t0) * 1e3,
            "error": err,
        })
    return rows


class SentinelPolicy:
    """Constructor-injected sentinel behavior (probe cadence, the fast
    timeout that bounds a wedged probe, and the probe itself) — the same
    injection shape the ROADMAP asks of device topology, so a test can
    hand the sentinel a canned probe and a laptop and a pod slice run
    the same daemon code."""

    __slots__ = ("interval", "timeout", "probe", "boot_timeout",
                 "device_probe")

    def __init__(self, interval: float = 5.0, timeout: float = 2.0,
                 probe=None, boot_timeout: float | None = None,
                 device_probe=None):
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.probe = probe if probe is not None else default_probe
        # per-device rows ride the same worker; an INJECTED headline
        # probe must stay in control of what the worker touches — with
        # a canned probe and no explicit device_probe, rows are
        # synthesized from the canned verdict instead of reaching the card
        if device_probe is not None:
            self.device_probe = device_probe
        elif probe is None:
            self.device_probe = probe_device_rows
        else:
            self.device_probe = None
        # until the runtime has answered ONCE, the probe budget covers
        # cold init (the first CUDA call in a process routinely
        # takes >2 s bringing the runtime up) — without this grace every
        # cold boot latches a spurious TPU_BACKEND_DEGRADED blip
        self.boot_timeout = (float(boot_timeout) if boot_timeout is not None
                             else max(15.0, 5.0 * self.timeout))


class BackendSentinel:
    """Latched backend health state + the probe loop (see module
    docstring).  Refcounted start: every OSD acquires it at boot with
    its conf-built policy (first acquirer's policy wins — the backend is
    per-process) and releases at shutdown; the loop stops with the last
    daemon."""

    def __init__(self, policy: SentinelPolicy | None = None):
        self._policy = policy or SentinelPolicy()
        self._lock = make_lock("telemetry::sentinel")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._refs = 0
        #: hot-path flag (ops.bitplane reads it per dispatch): plain
        #: attribute, flipped only inside _transition under _lock
        self.is_degraded = False
        self._forced: tuple[str, str] | None = None
        self._hung_probe: threading.Thread | None = None
        self._answered = False  # any probe ever returned (ok OR error)
        # the probe worker currently inside a per-device sweep (None =
        # idle); a still-ALIVE previous sweep worker suppresses new
        # sweeps, and its eventual answer still lands (the _hung_probe
        # pattern — a lock held across device round-trips could never
        # recover from a wedged device)
        self._sweep_worker: threading.Thread | None = None
        #: per-device probe rows from the last answering cycle (the
        #: ceph_backend_device_*{device} series + dump payload); the
        #: generation counter bumps on every non-sweep write so a
        #: STRAGGLING sweep worker (wedged device answering cycles
        #: later) cannot resurrect rows a reset/force/failure-mark
        #: already superseded
        self._devices: list[dict] = []
        self._dev_gen = 0
        self._st = {
            "state": "unknown", "reason": None, "since": None,
            "platform": None, "last_probe": None, "probes": 0,
            "transitions": 0,
        }

    # -- lifecycle (refcounted) --------------------------------------------
    def acquire(self, policy: SentinelPolicy | None = None) -> None:
        with self._lock:
            self._refs += 1
            if self._thread is not None:
                return
            if policy is not None:
                self._policy = policy
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="backend-sentinel", daemon=True)
            t = self._thread
        t.start()

    def release(self) -> None:
        with self._lock:
            self._refs = max(0, self._refs - 1)
            if self._refs:
                return
            self._stop.set()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    # -- state -------------------------------------------------------------
    def degraded(self) -> bool:
        return self.is_degraded

    def state(self) -> dict:
        with self._lock:
            return dict(self._st)

    def devices(self) -> list[dict]:
        """Per-device probe rows from the last answering cycle.  While
        the whole backend probe is failing/hung, the rows are the last
        known set with every verdict flipped to failed — each device is
        suspect until a probe answers again."""
        with self._lock:
            return [dict(d) for d in self._devices]

    def _mark_devices_failed(self, reason: str) -> None:
        """Flip every known row suspect.  Bumps the generation so any
        in-flight sweep's landing is invalidated (the sweep's OWN
        overrun mark is inlined in _probe_cycle instead — there the
        wedged worker's eventual answer is fresher and must land)."""
        with self._lock:
            self._dev_gen += 1
            for d in self._devices:
                d["ok"] = False
                d["error"] = reason

    def reset_state(self) -> None:
        """Back to pristine `unknown` (clears any force pin): tests and
        one-shot tools that must not leak latched state process-wide."""
        with self._lock:
            self._forced = None
            self._hung_probe = None
            self._sweep_worker = None
            self._answered = False
            self.is_degraded = False
            self._devices = []
            self._dev_gen += 1
            self._st = {
                "state": "unknown", "reason": None, "since": None,
                "platform": None, "last_probe": None, "probes": 0,
                "transitions": 0,
            }

    def force(self, state: str | None, reason: str = "") -> None:
        """Test/operator hook: pin the sentinel state ('degraded'/'ok'),
        applied immediately and held against probes until force(None)."""
        with self._lock:
            self._forced = None if state is None else (state, reason)
        if state is not None:
            self._transition(state == "degraded",
                             reason or f"forced {state}",
                             platform=None)

    # -- probing -----------------------------------------------------------
    def probe_once(self) -> dict:
        """One synchronous probe cycle (the loop body; also bench.py's
        entry).  Returns the resulting state dict."""
        self._probe_cycle()
        return self.state()

    def _loop(self) -> None:
        interval = max(0.05, self._policy.interval)
        while not self._stop.wait(timeout=interval):
            try:
                self._probe_cycle()
            except Exception as e:
                # the sentinel must never die to a probe bug; latch the
                # uncertainty instead
                self._transition(True, f"sentinel probe raised: {e!r}",
                                 platform=None)

    def _probe_cycle(self) -> None:
        with self._lock:
            forced = self._forced
            self._st["probes"] += 1
            self._st["last_probe"] = time.time()
            hung = self._hung_probe
        if forced is not None:
            degraded = forced[0] == "degraded"
            reason = forced[1] or f"forced {forced[0]}"
            with self._lock:
                self._devices = _forced_device_rows(not degraded, reason)
                self._dev_gen += 1
            self._transition(degraded, reason, platform=None)
            return
        if hung is not None and hung.is_alive():
            # the previous probe never answered: the backend is still
            # wedged — do not stack more hung workers
            self._mark_devices_failed("backend probe still hung")
            self._transition(True, "backend probe still hung", None)
            return
        box: dict = {}
        headline_done = threading.Event()
        done = threading.Event()

        def work():
            me = threading.current_thread()
            try:
                box["platform"] = self._policy.probe()
            except BaseException as e:
                box["error"] = f"{type(e).__name__}: {e}"
                headline_done.set()
                done.set()
                return
            headline_done.set()
            # per-device rows ride the same disposable worker AFTER the
            # headline verdict is out: N busy devices queueing behind
            # in-flight work must not eat the headline budget and latch
            # a spurious process-wide degraded.  A still-alive previous
            # sweep suppresses stacking (the _hung_probe pattern — a
            # held lock could never recover from a wedged device; a
            # thread marker clears the moment the device answers).
            with self._lock:
                busy = self._sweep_worker
                if busy is not None and busy.is_alive():
                    done.set()
                    return
                self._sweep_worker = me
                gen0 = self._dev_gen
            try:
                dp = self._policy.device_probe
                rows = dp() if dp is not None else [{
                    "device": f"{box['platform']}:0",
                    "platform": box["platform"], "ok": True,
                    "latency_ms": 0.0, "error": None,
                }]
                # land directly under the lock: a sweep that WEDGED on
                # a device and recovers cycles later must still refresh
                # the rows, even though its own probe cycle long moved
                # on — UNLESS a reset/force/failure-mark superseded the
                # generation it started from (stale rows must stay dead).
                # Landing and clearing the worker marker are ONE lock
                # block so the overrun path can never observe
                # landed-but-not-cleared and flip fresh rows to failed.
                with self._lock:
                    if self._dev_gen == gen0:
                        self._devices = list(rows)
                    self._sweep_worker = None
            except BaseException as e:
                box["devices_error"] = f"{type(e).__name__}: {e}"
            finally:
                with self._lock:
                    if self._sweep_worker is me:
                        self._sweep_worker = None
            done.set()

        t = threading.Thread(target=work, name="backend-probe", daemon=True)
        t.start()
        with self._lock:
            # the fast timeout applies once the runtime has answered at
            # least once; a cold process gets the boot grace instead
            timeout = (self._policy.timeout if self._answered
                       else self._policy.boot_timeout)
        if not headline_done.wait(timeout=timeout):
            with self._lock:
                self._hung_probe = t
            self._mark_devices_failed(
                f"backend probe timed out after {timeout}s")
            self._transition(
                True, f"backend probe timed out after {timeout}s", None)
            return
        with self._lock:
            self._hung_probe = None
            self._answered = True
        if "error" in box:
            self._mark_devices_failed(
                f"backend probe failed: {box['error']}")
            self._transition(True, f"backend probe failed: {box['error']}",
                             None)
        else:
            # the sweep gets its OWN grace equal to the probe budget;
            # on overrun the verdict stays healthy but every row flips
            # suspect (a wedged device must not keep reading ok=1), and
            # the wedged worker's eventual answer still refreshes them —
            # the process-wide latch keys off the headline probe only
            if not done.wait(timeout=timeout):
                # check + mark under ONE acquisition: a worker that
                # landed fresh rows and cleared the marker in between
                # must not have them flipped back to failed.  No gen
                # bump — the wedged worker's eventual answer is fresher
                # than this mark and must still land.
                with self._lock:
                    if self._sweep_worker is not None:
                        for d in self._devices:
                            d["ok"] = False
                            d["error"] = "device sweep hung"
            if "devices_error" in box:
                self._mark_devices_failed(
                    f"device sweep failed: {box['devices_error']}")
            self._transition(False, None, box.get("platform"))

    def _transition(self, degraded: bool, reason: str | None,
                    platform: str | None) -> None:
        """Apply a probe outcome; log + event only on EDGES so a wedged
        backend yields one alert, not one per probe."""
        with self._lock:
            was = self._st["state"]
            now_state = "degraded" if degraded else "ok"
            changed = was != now_state
            self._st["state"] = now_state
            self._st["reason"] = reason
            if platform is not None:
                self._st["platform"] = platform
            if changed:
                self._st["since"] = time.time()
                self._st["transitions"] += 1
            self.is_degraded = degraded
        if not changed:
            return
        if degraded:
            print(f"# ceph_tpu: backend sentinel DEGRADED: {reason}",
                  file=sys.stderr)
            TELEMETRY.record_event("sentinel_degraded", reason=reason)
        else:
            if was == "degraded":
                print("# ceph_tpu: backend sentinel recovered",
                      file=sys.stderr)
            TELEMETRY.record_event("sentinel_recovered",
                                   platform=platform)


SENTINEL = BackendSentinel()


def backend_health() -> dict:
    """The per-daemon health blob OSDs ship inside MMgrReport stats —
    the mgr status digest aggregates it and the mon `_health` turns it
    into TPU_BACKEND_DEGRADED / KERNEL_FALLBACK_LATCHED checks."""
    return {
        "sentinel": SENTINEL.state(),
        "fallback": TELEMETRY.fallback_latched(),
    }


def dump_kernel_telemetry() -> dict:
    """The `dump_kernel_telemetry` admin-socket payload."""
    return {
        "enabled": TELEMETRY.enabled,
        "kernels": TELEMETRY.dump(),
        "fallback": TELEMETRY.fallback_latched(),
        "sentinel": SENTINEL.state(),
        # cephplace satellite: one row per CUDA device with the last
        # probe's verdict + latency (ceph_backend_device_* on the
        # exporter; groundwork for mesh-shrink on a sick chip)
        "devices": SENTINEL.devices(),
        "events": TELEMETRY.events(),
    }
