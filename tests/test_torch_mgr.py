"""The port's mgr modules against the reference's, with no cluster.

Each module runs on a stub mgr (a ``SimpleNamespace`` with the map, a
mon-command channel and the report sink, as tests/test_placement_obs.py
hosts the balancer) in each package, fed the same inputs: the same map
(the port's is ``OSDMap.from_json(ref.to_json(), device="cpu")``, so its
batched mapping runs K3's plain version), the same report streams, the
same pg_stats sequence and the same telemetry.  Every output compared
here is integer or text, or floats computed by the same operations on
the same integers, so the tolerance is exact equality.

The placement scan and the balancer run on a 64-OSD map (16 hosts of 4)
with a size-3 replicated pool of 128 PGs and an RS(8,4) pool of 64 PGs;
the reference's batch mapper compiles once per rule shape, so every case
shares that map's shapes.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu import crush as ref_crush
from ceph_tpu import osd as ref_osd
from ceph_tpu.common.context import CephContext as RefContext
from ceph_tpu.mgr import balancer_module as ref_bal
from ceph_tpu.mgr import metrics_history as ref_mh
from ceph_tpu.mgr import placement_module as ref_plc
from ceph_tpu.mgr import progress_module as ref_prog
from ceph_tpu.mgr import prometheus_module as ref_prom
from ceph_tpu.mgr import qos_module as ref_qos
from ceph_tpu.mgr import status_module as ref_status
from ceph_tpu.common.perf_counters import HIST_LE
from ceph_tpu.osd import placement as ref_placement
from ceph_tpu_torch import osd as port_osd
from ceph_tpu_torch.common.context import CephContext as PortContext
from ceph_tpu_torch.crush import wrapper as port_wrapper
from ceph_tpu_torch.mgr import balancer_module as port_bal
from ceph_tpu_torch.mgr import metrics_history as port_mh
from ceph_tpu_torch.mgr import placement_module as port_plc
from ceph_tpu_torch.mgr import progress_module as port_prog
from ceph_tpu_torch.mgr import prometheus_module as port_prom
from ceph_tpu_torch.mgr import qos_module as port_qos
from ceph_tpu_torch.mgr import status_module as port_status
from ceph_tpu_torch.osd import placement as port_placement

SEED = 20261017
N_HOSTS, PER_HOST = 16, 4
REP, EC = 1, 2
#: PG shard bytes the OSDs report per pool (the remap forecast's weights)
STATS = {
    f"osd.{o}": {
        "pool_bytes": {str(REP): 4096 * (o + 1), str(EC): 1024 * (3 * o + 1)},
        "pool_objects": {str(REP): 3 * (o + 1), str(EC): 12 * (o % 5)},
        "statfs": {"total": 1 << 30, "used": 4096 * (o + 7),
                   "avail": (1 << 30) - 4096 * (o + 7)},
        "num_pgs": 10 + o % 7, "num_objects": 5 * o,
        **({"slow_ops": 2, "slow_ops_detail": ["op stuck in stage_queue"]}
           if o == 3 else {}),
        "pg_info": {f"{REP}.{ps:x}": {"degraded": (o + ps) % 3,
                                      "state": "active+clean"}
                    for ps in range(o % 4)},
    }
    for o in range(N_HOSTS * PER_HOST)
}


def ref_map():
    m = ref_osd.OSDMap(ref_crush.CrushWrapper(
        ref_crush.build_hierarchical_map(N_HOSTS, PER_HOST)))
    m.create_pool(REP, pg_num=128, size=3, crush_rule=0, name="rbd")
    m.create_pool(EC, pg_num=64, size=12, crush_rule=1,
                  type=ref_osd.PG_POOL_ERASURE, name="rs84", ec_profile="rs84")
    m.ec_profiles["rs84"] = {"plugin": "jax", "k": "8", "m": "4"}
    return m


def port_of(m):
    return port_osd.OSDMap.from_json(m.to_json(), device="cpu")


PKGS = {
    "ref": SimpleNamespace(ctx=lambda o: RefContext("mgr.test", overrides=o),
                           bal=ref_bal, plc=ref_plc, mh=ref_mh, prog=ref_prog,
                           prom=ref_prom, qos=ref_qos, status=ref_status,
                           placement=ref_placement, of=lambda m: m),
    "port": SimpleNamespace(ctx=lambda o: PortContext("mgr.test", overrides=o,
                                                      device="cpu"),
                            bal=port_bal, plc=port_plc, mh=port_mh,
                            prog=port_prog, prom=port_prom, qos=port_qos,
                            status=port_status, placement=port_placement,
                            of=port_of),
}


class StubMgr(SimpleNamespace):
    """What the modules reach of MgrDaemon: the map and the mon-command
    channel through ``mc``, the report views, the report sink."""

    def __init__(self, pkg, m, overrides=None, command=None, stats=None,
                 degraded=None):
        cmds = []
        super().__init__(
            cct=pkg.ctx(dict(overrides or {})),
            mc=SimpleNamespace(osdmap=m, command=command or (
                lambda cmd: cmds.append(cmd) or (0, {}))),
            commands=cmds, _modules={}, exported=[],
            metrics_history=pkg.mh.MetricsHistory(),
        )
        stats = stats or {}
        self.latest_stats = lambda: stats
        self.latest_stats_with_ts = lambda: {
            d: (float(i), s) for i, (d, s) in enumerate(sorted(stats.items()))}
        self.pg_degraded_by_pgid = lambda: dict(degraded or {})
        self.ingest_local_report = lambda d, c, schema=None: \
            self.exported.append((d, c, schema))


def plain(x):
    """numpy values and containers as plain Python, for == on both."""
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def without(d: dict, *keys):
    return {k: v for k, v in d.items() if k not in keys}


@pytest.fixture(scope="module")
def stubs():
    made = []

    def make(name, m, **kw):
        mgr = StubMgr(PKGS[name], m, **kw)
        made.append(mgr)
        return mgr
    yield make
    for mgr in made:
        mgr.cct.shutdown()


# ---- placement: the per-epoch scan and its remap forecast --------------


@pytest.fixture(scope="module")
def scans(stubs):
    """Each package's placement module scans the map, then the map with
    two OSDs out (the next epoch); returns both scans' reports, the
    snapshot after the second and what each exported."""
    out = {}
    ref0 = ref_map()
    ref1 = ref_osd.OSDMap.from_json(ref0.to_json())
    ref1.mark_out(5)
    ref1.mark_out(37)
    for name, pkg in PKGS.items():
        mgr = stubs(name, pkg.of(ref0), stats=STATS)
        pm = pkg.plc.PlacementModule(mgr)
        first = pm.scan()
        mgr.mc.osdmap = pkg.of(ref1)
        second = pm.scan()
        out[name] = {"first": first, "second": second, "pm": pm,
                     "snapshot": pm.snapshot(), "exported": mgr.exported,
                     "df": pm.df_inputs(), "imbalanced": pm.imbalanced()}
    out["json"] = (ref0.to_json(), ref1.to_json())
    return out


def test_placement_scan_report(scans):
    ref, port = scans["ref"], scans["port"]
    for scan in ("first", "second"):
        assert plain(port[scan]) == plain(ref[scan]), scan
    assert port["first"]["epoch"] == 1 and port["second"]["epoch"] == 3
    assert plain(port["df"]) == plain(ref["df"])
    assert port["imbalanced"] == ref["imbalanced"]


def test_placement_remap_forecast_after_osd_out(scans):
    ref, port = scans["ref"], scans["port"]
    diff = port["snapshot"]["diff"]
    assert diff["from_epoch"] == 1 and diff["to_epoch"] == 3
    assert diff["pgs_remapped"] > 0 and diff["predicted_bytes"] > 0
    assert without(diff, "age_seconds") == without(ref["snapshot"]["diff"],
                                                   "age_seconds")
    assert without(port["snapshot"], "diff") == without(ref["snapshot"], "diff")
    # the forecast is diff_mappings of the two epochs' batched mappings,
    # the same in each package's function on the same map JSON
    for name, pkg in PKGS.items():
        m0, m1 = (pkg.of(ref_osd.OSDMap.from_json(j)) for j in scans["json"])
        want = pkg.placement.diff_mappings(
            m1, {pid: m0.map_pool(pid)[0] for pid in m0.pools},
            {pid: m1.map_pool(pid)[0] for pid in m1.pools},
            shard_bytes=scans[name]["pm"]._shard_bytes(m1))
        assert plain(want) == plain(without(scans[name]["pm"]._last_diff,
                                            "from_epoch", "to_epoch")), name


def test_placement_exported_series(scans):
    ref, port = scans["ref"], scans["port"]
    assert plain(port["exported"]) == plain(ref["exported"])
    assert [d for d, _c, _s in port["exported"]] == ["mgr.placement"] * 2


# ---- the balancer: a pass on a scratch copy of the live map ------------


def _balancer_pass(stubs, name, **kw):
    pkg = PKGS[name]
    mgr = stubs(name, pkg.of(ref_map()), **kw)
    bal = pkg.bal.BalancerModule(mgr)
    changes = bal.optimize_once()
    st = bal.status()
    st["last_pass"] = without(st["last_pass"] or {}, "ts")
    return {"changes": [tuple(int(v) for v in c) for c in changes],
            "status": without(st, "last_pass_age_seconds"),
            "exported": mgr.exported, "commands": mgr.commands,
            "live_upmaps": dict(mgr.mc.osdmap.pg_upmap_items)}


def test_balancer_dry_run_proposals_and_scores(stubs):
    got = {name: _balancer_pass(stubs, name,
                                overrides={"mgr_balancer_active": False})
           for name in PKGS}
    ref, port = got["ref"], got["port"]
    assert port["changes"], "a 64-OSD CRUSH spread leaves moves to propose"
    assert port["changes"] == ref["changes"]
    assert port["status"] == ref["status"]
    lp = port["status"]["last_pass"]
    assert lp["proposed"] == len(port["changes"]) and lp["committed"] == 0
    assert lp["score_after"]["score"] <= lp["score_before"]["score"]
    assert plain(port["exported"]) == plain(ref["exported"])
    # dry run: nothing commits, the live map keeps no upmaps
    assert port["commands"] == [] and port["live_upmaps"] == {}


def test_balancer_counts_refused_commits(stubs):
    got = {name: _balancer_pass(stubs, name,
                                overrides={"mgr_balancer_active": True},
                                command=lambda cmd: (-22, "refused"))
           for name in PKGS}
    ref, port = got["ref"], got["port"]
    st = port["status"]
    assert st["balancer_errors"] > 0 and st["moves_committed"] == 0
    assert "refused" in st["last_error"]
    assert st["last_pass"]["score_after"] == st["last_pass"]["score_before"]
    assert port["changes"] == ref["changes"]
    assert st == ref["status"]
    assert plain(port["exported"]) == plain(ref["exported"])


def test_balancer_skips_a_degraded_cluster(stubs):
    got = {name: _balancer_pass(stubs, name,
                                overrides={"mgr_balancer_active": True},
                                degraded={"1.0": 3, "1.4": 0, "2.1": 2})
           for name in PKGS}
    st = got["port"]["status"]
    assert got["port"]["changes"] == [] and st["passes"] == 0
    assert st["passes_skipped"] == 1
    assert without(st, "last_skip", "last_skip_age_seconds") == without(
        got["ref"]["status"], "last_skip", "last_skip_age_seconds")
    assert st["last_skip"]["reason"] == got["ref"]["status"]["last_skip"]["reason"]


# ---- the compiled-map cache the scan and the balancer rely on ----------


def test_compiled_map_shared_across_decode_and_deepcopy(stubs, monkeypatch):
    """A fresh decode of the same crush content (the mgr's map each
    epoch) and the balancer's scratch deepcopy resolve the same
    CompiledCrushMap from the (digest, device) cache, with its magic
    reciprocal tables; a placement scan and a balancer pass on a decoded
    map build none."""
    m1 = port_of(ref_map())
    c1 = m1.crush.compiled("cpu")
    m2 = port_osd.OSDMap.from_json(m1.to_json(), device="cpu")
    assert m2.crush.compiled("cpu") is c1
    scratch = copy.deepcopy(m1)
    assert scratch.crush.compiled("cpu") is c1
    assert scratch.crush.compiled("cpu").magic_m is c1.magic_m
    built = []
    real = port_wrapper.CompiledCrushMap

    def counting(*a, **kw):
        built.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(port_wrapper, "CompiledCrushMap", counting)
    mgr = stubs("port", port_osd.OSDMap.from_json(m1.to_json(), device="cpu"),
                overrides={"mgr_balancer_active": False})
    assert port_plc.PlacementModule(mgr).scan() is not None
    assert port_bal.BalancerModule(mgr).optimize_once()
    assert built == []
    # content mutation misses (and leaves the original entry alone)
    m3 = port_osd.OSDMap.from_json(m1.to_json(), device="cpu")
    m3.crush.reweight_item("osd.0", 0.0)
    assert m3.crush.compiled("cpu") is not c1
    assert len(built) == 1
    assert m1.crush.compiled("cpu") is c1


# ---- prometheus: the text exposition ------------------------------------


def _hist(rng, n):
    b = rng.integers(0, 50, len(HIST_LE) + 1).tolist()
    return {"buckets": b, "sum": float(n) * 0.125, "count": int(sum(b))}


def _reports(rng):
    reports = {}
    for o in range(4):
        reports[f"osd.{o}"] = {
            "osd": {"op": int(rng.integers(0, 1000)),
                    "op_w_bytes": int(rng.integers(0, 1 << 30)),
                    "numpg": 17 + o,
                    "op_latency": {"avgcount": 12 + o, "sum": 0.5 * o},
                    "stage_queue": _hist(rng, o)},
            "client_io": {"per_client": {"__labeled__": True, "rows": [
                {"labels": {"client": f"client.{c}", "pool": 'p"1\n'},
                 "ops_w": int(rng.integers(1, 99)),
                 "lat": _hist(rng, c)} for c in range(3)]}},
            "backend": {"device": {"__labeled__": True, "rows": [
                {"labels": {"device": "cuda:0"}, "device_ok": 1,
                 "device_probe_ms": 0.25}]}},
        }
    reports["mgr.placement"] = {"placement": {"score": 0.125, "epoch": 9}}
    return reports


SCHEMA = {
    "osd": {"op": {"type": "u64", "description": "client ops"},
            "numpg": {"type": "gauge", "description": "placement groups"},
            "stage_queue": {"type": "histogram",
                            "description": "queue stage latency"}},
    "client_io": {"ops_w": {"type": "u64", "description": "writes"}},
    "backend": {"device_ok": {"type": "gauge", "description": "probe ok"}},
}
HEALTH = {"health": {"status": "HEALTH_WARN", "checks": {
    "TPU_BACKEND_DEGRADED": {"severity": "HEALTH_WARN", "summary": "x"},
    "KERNEL_FALLBACK_LATCHED": {"severity": "HEALTH_WARN"},
    "PG_IMBALANCE": {"severity": "HEALTH_WARN"}}}}


def test_render_metrics_byte_equal():
    ref = ref_map()
    ref.mark_down(3)
    ref.mark_out(5)
    reports = _reports(np.random.default_rng(SEED))
    for health in (None, HEALTH):
        want = ref_prom.render_metrics(ref, reports, schema=SCHEMA,
                                       health=health)
        got = port_prom.render_metrics(port_of(ref), reports, schema=SCHEMA,
                                       health=health)
        assert got == want
    assert 'ceph_health_detail{name="TPU_BACKEND_DEGRADED"' in got
    assert 'ceph_backend_device_ok{ceph_daemon="osd.0",device="cuda:0"} 1' in got
    assert port_prom.render_metrics(None, {}) == ref_prom.render_metrics(None, {})


# ---- metrics history: the ring and its queries --------------------------


def test_metrics_history_queries():
    rng = np.random.default_rng(SEED)
    stores = {n: p.mh.MetricsHistory(max_samples=8, max_series=16,
                                     forget_age=30.0)
              for n, p in PKGS.items()}
    totals = {}
    for step in range(24):
        ts = 100.0 + 0.5 * step
        for d in ("osd.0", "osd.1", "osd.2"):
            if d == "osd.2" and step > 10:
                continue  # goes silent: hidden by max_age, then forgotten
            t = totals.setdefault(d, {"op": 0, "op_w": 0})
            t["op"] += int(rng.integers(0, 40))
            t["op_w"] += int(rng.integers(0, 20))
            if d == "osd.1" and step == 15:
                t["op"] = 3  # a restart: the counter starts over
            counters = {"osd": {**t, "up": True,
                                "op_latency": {"avgcount": step, "sum": step / 8},
                                "stage_queue": _hist(rng, step),
                                "rows": {"__labeled__": True, "rows": []}}}
            for s in stores.values():
                s.add_report(d, ts, counters)
        if step == 20:
            for s in stores.values():
                s.add_report("osd.0", ts, {"osd": {"op": 0}})  # same-ts replay
    ref, port = stores["ref"], stores["port"]
    assert port.names() == ref.names() and port.daemons() == ref.daemons()
    for name in ref.names():
        assert port.series(name) == ref.series(name), name
        assert port.series(name, since=105.0) == ref.series(name, since=105.0)
        for d in ref.daemons():
            assert port.latest(name, d) == ref.latest(name, d)
            assert port.rate(name, daemon=d) == ref.rate(name, daemon=d)
        for max_age in (None, 2.0):
            assert port.rate(name, max_age=max_age, now=112.0) == \
                ref.rate(name, max_age=max_age, now=112.0)
        cursors = {"osd.0": 104.0, "osd.1": 90.0}
        assert port.rate_since(name, cursors, now=112.0) == \
            ref.rate_since(name, cursors, now=112.0)
    assert port.stats() == ref.stats() and port.stats()["dropped_series"] > 0
    assert port.digest() == ref.digest()


# ---- progress: recovery events from the pg_stats sequence --------------


def test_progress_events_from_pg_stats(stubs):
    seq = [
        (10.0, {"1.0": 12, "1.1": 0, "2.3": 5}),
        (11.0, {"1.0": 9, "1.1": 4, "2.3": 5}),
        (12.5, {"1.0": 9, "1.1": 2, "2.3": 7}),   # 2.3 regresses
        (14.0, {"1.0": 3, "1.1": 0, "2.3": 7}),   # 1.1 completes
        (30.0, {"1.0": 3, "2.3": 6}),             # 1.0 stalls
        (41.0, {"1.0": 0, "2.3": 6}),
        (80.0, {"2.3": 1}),
    ]
    got = {}
    for name, pkg in PKGS.items():
        tr = pkg.prog.ProgressTracker(stalled_grace=10.0)
        mgr = stubs(name, None, overrides={"mgr_recovery_stalled_grace": 10.0})
        mod = pkg.prog.ProgressModule(mgr)
        rows = []
        for ts, deg in seq:
            tr.update(ts, deg, recovery_rate=0.05 if ts < 40 else 0.5)
            mgr.pg_degraded_by_pgid = lambda deg=deg: deg
            mod.tick(now=ts)
            rows.append((tr.events(), tr.completed(), tr.stalled(ts + 15.0),
                         mod.snapshot(now=ts + 15.0)))
        got[name] = (rows, mgr.exported)
    assert got["port"] == got["ref"]
    events, done, stalled, _snap = got["port"][0][4]
    assert [e["pgid"] for e in events] == ["1.0", "2.3"] and done
    assert stalled and stalled[0]["pgid"] == "2.3"


# ---- qos: the controller's plan from the same telemetry ----------------


def _qos_reports(rng, tick):
    out = {}
    for o in range(3):
        out[f"osd.{o}"] = {
            "osd": {"stage_queue": {"buckets": (rng.integers(0, 30 + 40 * tick,
                                                            len(HIST_LE) + 1)
                                                .cumsum().tolist()),
                                    "sum": 1.0, "count": 1},
                    "stage_encode": _hist(rng, o)},
            "client_io": {"per_client": {"__labeled__": True, "rows": [
                {"labels": {"client": f"client.{c}", "pool": "p"},
                 "ops_w": (1 + tick) * (400 if c == 0 else 7 + c)}
                for c in range(4)]}},
        }
    return out


def test_qos_plan_from_the_same_telemetry(stubs, monkeypatch):
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    got = {}
    for name, pkg in PKGS.items():
        rng = np.random.default_rng(SEED)
        mgr = stubs(name, None, overrides={"mgr_qos_active": False})
        mod = pkg.qos.QoSModule(mgr)
        out = []
        for tick in range(4):
            clock["t"] = 1000.0 + 2.0 * tick
            reports = _qos_reports(rng, tick)
            mgr.latest_reports = lambda reports=reports: reports
            for d, r in reports.items():
                mgr.metrics_history.add_report(d, clock["t"], {
                    "osd": {"op_w": 100 * tick * (1 + int(d[-1])),
                            "ec_batch_stripes": 40 * tick,
                            "ec_batch_flushes": 3 * tick}})
            obs = mod.observe()
            plan = pkg.qos.QoSController(mod._clamps()).plan(obs)
            out.append((dataclasses.asdict(obs), plan, mod.tick()))
        plans = [pkg.qos.QoSController(pkg.qos.QoSClamps()).plan(
            pkg.qos.QoSObservation(window_ms=w, max_stripes=s, queue_p99_ms=q,
                                   encode_p99_ms=e, op_rate=r,
                                   stripes_per_flush=f,
                                   per_client_rates={"a/p": r, "b/p": 1.0,
                                                     "c/p": 2.0}))
            for w, s, q, e, r, f in [(2.0, 64, None, None, 0.0, None),
                                     (2.0, 64, 80.0, 30.0, 500.0, 60.0),
                                     (5.0, 32, 10.0, 150.0, 900.0, 31.0),
                                     (0.4, 300, 39.0, None, 50.0, 10.0)]]
        got[name] = (out, plans, mod.status(), mgr.exported)
    assert got["port"] == got["ref"]
    assert any(p["classes"] for p in got["port"][1])


# ---- status: the digest and the views built from it --------------------


def test_status_digest_and_views(stubs):
    ref = ref_map()
    ref.mark_down(7)
    got = {}
    for name, pkg in PKGS.items():
        m = pkg.of(ref)
        mgr = stubs(name, m, stats=STATS)
        for d in ("osd.0", "osd.1"):
            for i in range(3):
                mgr.metrics_history.add_report(d, 50.0 + i, {
                    "osd": {"op": 10 * i, "op_w_bytes": 4096 * i}})
        mod = pkg.status.StatusModule(mgr)
        got[name] = (mod.build_digest(), mod.osd_status(),
                     pkg.status.assemble_df(m, STATS),
                     pkg.status.assemble_osd_rows(m, STATS),
                     pkg.status.pool_usage(m, STATS))
    assert plain(got["port"]) == plain(got["ref"])
    digest = got["port"][0]
    assert digest["osd_df"]["nodes"] and digest["slow_ops"] == {"osd.3": 2}
    assert {p["name"] for p in digest["df"]["pools"]} == {"rbd", "rs84"}
