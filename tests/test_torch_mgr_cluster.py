"""The port's mgr in a running cluster: the cluster cases of
tests/test_mgr.py and tests/test_placement_obs.py::TestClusterObservability
on ``LocalCluster(with_mgr=True, device="cpu")``, with the reference's
overrides, one cluster per conf in a class-scoped fixture (so each stops
before the next starts: never two at once), and last the port's recovery
smoke on the CPU.

They assert what the reference's cases assert.  Where a result depends
only on the map (the placement scan's report, the remap forecast), it is
also held against the reference package's function on the same map JSON,
exactly: both are integer counts and floats of the same operations.
"""
from __future__ import annotations

import time
import urllib.request

import numpy as np
import pytest

from ceph_tpu.osd import OSDMap as RefOSDMap
from ceph_tpu.osd.placement import cluster_report as ref_cluster_report
from ceph_tpu.osd.placement import diff_mappings as ref_diff_mappings
from ceph_tpu_torch.common.kernel_telemetry import TELEMETRY
from ceph_tpu_torch.qa.smoke_util import wait_for as _wait
from ceph_tpu_torch.qa.vstart import LocalCluster

pytestmark = pytest.mark.cluster


def _scrape(c) -> str:
    url = c.mgr.module("prometheus").url
    return urllib.request.urlopen(url, timeout=10).read().decode()


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


# ---- tests/test_mgr.py: the default modules ----------------------------


class TestDefaultModules:
    @pytest.fixture(scope="class")
    def mgr_cluster(self):
        with LocalCluster(
            n_mons=1, n_osds=4, with_mgr=True, device="cpu",
            conf_overrides={
                "mgr_report_interval": 0.4,
                # balancer runs on demand in tests, not on a racy timer
                "mgr_balancer_interval": 3600.0,
                "mgr_quota_interval": 0.4,
            },
        ) as c:
            c.create_ec_pool("ec", k=2, m=1)
            yield c

    def test_mgr_runs_on_the_cluster_device(self, mgr_cluster):
        c = mgr_cluster
        assert str(c.mgr.device) == "cpu" and str(c.mgr.cct.device) == "cpu"
        assert str(c.mgr.mc.osdmap.device) == "cpu"
        assert c.mgr.failed_modules == {}

    def test_prometheus_scrape_end_to_end(self, mgr_cluster):
        c = mgr_cluster
        io = c.client().open_ioctx("ec")
        for i in range(5):
            io.write_full(f"m{i}", b"z" * 2048)
        assert c.mgr.module("prometheus").url, "prometheus module exposes no url"
        deadline = time.time() + 15
        while True:
            body = _scrape(c)
            # the primaries that served the writes report op counters
            ops = sum(int(float(line.rsplit(" ", 1)[1]))
                      for line in body.splitlines()
                      if line.startswith("ceph_osd_op{"))
            if ops >= 5:
                break
            assert time.time() < deadline, f"op counters never reached 5:\n{body[:800]}"
            time.sleep(0.5)
        assert "ceph_osd_up{" in body
        assert "ceph_osdmap_epoch" in body

    def test_osd_report_places_pgs_from_the_shared_placements(self, mgr_cluster,
                                                              monkeypatch):
        """An OSD's MMgrReport places its PGs from the process's shared
        placements of the map (osd/daemon.py::_placements_of), not by a
        scalar CRUSH descent per PG per report: in every OSD of a 12-OSD
        cluster with an RS(8,4) pool that starved the cluster of the
        interpreter lock (clean in over 600 s against 2 s without the mgr)."""
        import sys

        from ceph_tpu_torch.osd.osdmap import OSDMap

        osd = mgr_cluster.osds[0]
        direct = []
        real = OSDMap.pg_to_up_acting_osds

        def spy(self, *a):
            if sys._getframe(1).f_code.co_filename.endswith("split_migration.py"):
                direct.append(a)
            return real(self, *a)
        monkeypatch.setattr(OSDMap, "pg_to_up_acting_osds", spy)
        osd._mgr_report()
        assert osd.pgs and direct == []

    def test_status_module(self, mgr_cluster):
        c = mgr_cluster
        deadline = time.time() + 10
        while True:
            st = c.mgr.module("status").osd_status()
            if st["osds"] and any(r["pgs"] for r in st["osds"]):
                break
            assert time.time() < deadline, st
            time.sleep(0.5)
        assert len(st["osds"]) == 4
        assert all(r["up"] for r in st["osds"])

    def test_status_command_shows_the_digest(self, mgr_cluster):
        """`ceph -s` folds the mgr digest's usage and pg states in."""
        c = mgr_cluster

        def ready():
            rv, st = c.mon_command({"prefix": "status"})
            return rv == 0 and st.get("usage", {}).get("total_bytes") and \
                st.get("pgs_by_state")
        assert _wait(ready, 30.0)
        rv, st = c.mon_command({"prefix": "status"})
        assert st["usage"]["total_bytes"] > 0
        assert sum(st["pgs_by_state"].values()) >= 1

    def test_balancer_module_converges(self, mgr_cluster):
        c = mgr_cluster
        bal = c.mgr.module("balancer")
        epoch_before = c.mgr.mc.osdmap.epoch
        changes = bal.optimize_once()
        assert bal.passes == 1
        if changes:
            # commits went through the mon: the map epoch moved and carries
            # the upmap items
            deadline = time.time() + 10
            while c.mgr.mc.osdmap.epoch <= epoch_before:
                assert time.time() < deadline, "no new map after balancer"
                time.sleep(0.2)
            assert c.mgr.mc.osdmap.pg_upmap_items
        # a second pass on the (now balanced) map proposes nothing new
        again = bal.optimize_once()
        assert len(again) <= len(changes)

    def test_iostat_module_reports_rates(self, mgr_cluster):
        c = mgr_cluster
        io_mod = c.mgr.module("iostat")  # hosted: iostat is a default module
        io_mod.sample()  # prime the baseline
        io = c.client().open_ioctx("ec")
        for i in range(20):
            io.write_full(f"iostat-{i}", b"x" * 4096)
        for i in range(20):
            io.read(f"iostat-{i}")
        deadline = time.time() + 15
        while True:
            time.sleep(1.0)  # let a fresh MMgrReport land
            s = io_mod.sample()
            if s["wr_ops_per_s"] > 0 and s["rd_ops_per_s"] > 0:
                break
            assert time.time() < deadline, s
        assert s["wr_bytes_per_s"] > 0
        assert s["daemons"], "no per-daemon rates"
        # rates settle back toward zero once IO stops
        deadline = time.time() + 20
        while True:
            time.sleep(1.5)
            s2 = io_mod.sample()
            if s2["ops_per_s"] == 0:
                break
            assert time.time() < deadline, s2

    def test_pool_quota_enforced_and_lifted(self, mgr_cluster):
        """The mgr's quota loop flags an over-quota pool, writes then refuse
        with EDQUOT (deletes still allowed), and deleting under quota lifts
        the flag."""
        c = mgr_cluster
        c.create_replicated_pool("qp", size=2)
        rv, res = c.mon_command({"prefix": "osd pool set-quota", "name": "qp",
                                 "field": "max_objects", "value": 5})
        assert rv == 0, res
        io = c.client().open_ioctx("qp")
        for i in range(5):
            io.write_full(f"q{i}", b"x" * 1000)

        def flagged() -> bool:
            m = c._leader().osdmon.osdmap
            return "full_quota" in next(p for p in m.pools.values()
                                        if p.name == "qp").flags
        assert _wait(flagged, 25.0), "pool never flagged full"
        # writes refuse FAST with EDQUOT once OSDs see the flag
        deadline = time.time() + 15
        while True:
            try:
                io.write_full("overflow", b"y")
            except IOError as e:
                assert "-122" in str(e) or "EDQUOT" in str(e) or \
                    "quota" in str(e).lower(), e
                break
            assert time.time() < deadline, "write never hit the quota"
            time.sleep(0.3)
        rv, res = c.mon_command({"prefix": "osd pool get-quota", "name": "qp"})
        assert rv == 0 and res["full"] is True
        for i in range(5):
            io.remove(f"q{i}")
        assert _wait(lambda: not flagged(), 25.0), "flag never lifted"
        io.write_full("after", b"ok again")
        assert io.read("after") == b"ok again"


# ---- tests/test_mgr.py: devicehealth and the dashboard -----------------


class TestDevicehealthAndDashboard:
    @pytest.fixture(scope="class")
    def dd_cluster(self):
        with LocalCluster(
            n_mons=1, n_osds=3, with_mgr=True, device="cpu",
            conf_overrides={
                "mgr_report_interval": 0.5,
                "mgr_tick_interval": 0.5,
                "mgr_modules": "status,devicehealth,dashboard",
                "mgr_devicehealth_mark_out_threshold": 3,
                # 3-OSD cluster: one mark-out leaves 2/3 in; the default
                # 0.75 floor would (correctly) refuse every self-heal
                "mgr_devicehealth_min_in_ratio": 0.5,
            },
        ) as c:
            c.create_replicated_pool("dh", size=2)
            yield c

    def test_dashboard_endpoints(self, dd_cluster):
        import json

        io = dd_cluster.client().open_ioctx("dh")
        io.write_full("seen", b"x" * 1000)
        mod = dd_cluster.mgr.module("dashboard")
        assert _wait(lambda: any(r["up"] for r in mod.osd_rows() or []), 15.0)
        page = urllib.request.urlopen(mod.url, timeout=10).read().decode()
        assert "<h1>cluster: HEALTH_" in page and "osd.0" in page
        api = json.loads(urllib.request.urlopen(
            mod.url + "api/osd?format=json", timeout=10).read())
        assert {r["id"] for r in api} == {0, 1, 2}
        pools = json.loads(urllib.request.urlopen(mod.url + "api/pool",
                                                  timeout=10).read())
        assert any(p["name"] == "dh" for p in pools)

    def test_devicehealth_tracks_and_marks_out(self, dd_cluster):
        mod = dd_cluster.mgr.module("devicehealth")
        assert _wait(lambda: len(mod.status()["tracked"]) >= 3, 15.0)
        # a rotting device: osd.2's scrub_errors counter climbs
        victim = dd_cluster.osds[2]
        for _ in range(4):
            victim.logger.inc("scrub_errors")
        assert _wait(lambda: "osd.2" in mod.status()["warnings"]
                     and 2 in mod.status()["marked_out"], 30.0)
        st = mod.status()
        assert st["warnings"]["osd.2"]["new_errors"] >= 4
        cl = dd_cluster.client("client.dhchk")
        assert _wait(lambda: cl.mc.osdmap is not None and not cl.mc.osdmap.is_in(2),
                     15.0)
        cl.shutdown()
        # the in-ratio floor now blocks further self-heals (2/3 in; another
        # mark-out would leave 1/3 < 0.5)
        victim2 = dd_cluster.osds[1]
        for _ in range(4):
            victim2.logger.inc("scrub_errors")
        _wait(lambda: "osd.1" in mod.status()["warnings"], 8.0)
        time.sleep(2)  # give self-heal passes a chance to (wrongly) fire
        assert 1 not in mod.status()["marked_out"], "ratio floor ignored"


# ---- tests/test_placement_obs.py::TestClusterObservability -------------


class TestClusterObservability:
    @pytest.fixture(scope="class")
    def obs_cluster(self):
        with LocalCluster(
            n_mons=1, n_osds=4, with_mgr=True, device="cpu",
            conf_overrides={
                "mgr_report_interval": 0.2,
                "mgr_digest_interval": 0.2,
                # scans driven by hand below — no timer races
                "mgr_placement_interval": 3600.0,
                "mgr_balancer_interval": 3600.0,
                "mgr_balancer_active": False,
            },
        ) as c:
            c.create_replicated_pool("plc", size=2, pg_num=16)
            io = c.client().open_ioctx("plc")
            for i in range(4):
                io.write_full(f"o{i}", b"x" * 4096)
            assert _wait(lambda: c.mgr.mc.osdmap is not None
                         and c.mgr.mc.osdmap.pools, 15.0)
            yield c

    def test_balancer_dry_run_mode(self, obs_cluster):
        """mgr_balancer_active=False proposes but never commits."""
        c = obs_cluster
        bal = c.mgr.module("balancer")
        changes = bal.optimize_once()
        time.sleep(1.0)
        assert not c.mgr.mc.osdmap.pg_upmap_items
        assert bal.status()["last_pass"]["proposed"] == len(changes)
        assert bal.status()["moves_committed"] == 0

    def test_placement_series_and_commands(self, obs_cluster):
        c = obs_cluster
        calls0 = (TELEMETRY.dump().get("crush_do_rule_batch") or {}).get("calls", 0)
        pm = c.mgr.module("placement")
        rep = pm.scan()
        assert rep is not None and rep["score"] >= 0.0
        # the scan ran through the batched mapper on the cluster's device
        # (K3's plain version here, K3 on a card), not a per-PG host loop
        row = TELEMETRY.dump()["crush_do_rule_batch"]
        assert row["calls"] > calls0 and row["last_backend"] == "cpu"
        # a result of the map alone: the reference's scoring core on the
        # same map JSON gives the same report
        ref_m = RefOSDMap.from_json(pm._map.to_json())
        assert _plain(rep) == _plain(ref_cluster_report(ref_m))
        wanted = ("ceph_placement_pool_score",
                  "ceph_placement_pool_max_deviation",
                  "ceph_placement_osd_shards",
                  "ceph_placement_osd_deviation",
                  "ceph_remap_epochs_diffed",
                  "ceph_balancer_passes")
        assert _wait(lambda: all(m in _scrape(c) for m in wanted), 10.0), \
            f"metrics missing from exposition: {wanted}"
        body = _scrape(c)
        assert 'pool="plc"' in body and 'osd="osd.0"' in body
        # mon commands answer from the digest
        assert _wait(lambda: c.mon_command({"prefix": "balancer status"})[0] == 0,
                     10.0)
        rv, bs = c.mon_command({"prefix": "balancer status"})
        assert rv == 0 and bs["passes"] >= 0 and "active" in bs

        def pools_visible():
            rv2, pd = c.mon_command({"prefix": "placement diff"})
            return rv2 == 0 and any(p["pool"] == "plc" for p in pd["pools"])
        assert _wait(pools_visible, 10.0)

    def test_remap_forecast_on_mark_out(self, obs_cluster):
        c = obs_cluster
        pm = c.mgr.module("placement")
        pm.scan()  # prime the previous-epoch mapping cache
        before = pm._map
        rv, _ = c.mon_command({"prefix": "osd out", "id": 3})
        assert rv == 0
        assert _wait(lambda: not c.mgr.mc.osdmap.is_in(3), 10.0)
        pm.scan()
        after = pm._map
        diff = pm.snapshot()["diff"]
        assert diff is not None and diff["pgs_remapped"] > 0
        assert 0 < diff["misplaced_fraction"] <= 1
        # the scalar ground truth: PGs whose up set gained an OSD it lacked
        pid = next(i for i, p in after.pools.items() if p.name == "plc")
        moved = sum(
            bool(set(after.pg_to_up_acting_osds(pid, ps)[0])
                 - set(before.pg_to_up_acting_osds(pid, ps)[0]))
            for ps in range(after.pools[pid].pg_num))
        assert diff["pools"][str(pid)]["pgs_remapped"] == moved
        # and the reference's forecast on the same two maps' JSON
        r0, r1 = (RefOSDMap.from_json(m.to_json()) for m in (before, after))
        want = ref_diff_mappings(r1, {p: r0.map_pool(p)[0] for p in r0.pools},
                                 {p: r1.map_pool(p)[0] for p in r1.pools},
                                 shard_bytes=pm._shard_bytes(after))
        got = {k: v for k, v in pm._last_diff.items()
               if k not in ("from_epoch", "to_epoch")}
        assert _plain(got) == _plain(want)

        def diff_visible():
            rv2, pd = c.mon_command({"prefix": "placement diff"})
            return rv2 == 0 and (pd.get("diff") or {}).get("pgs_remapped", 0) > 0
        assert _wait(diff_visible, 10.0)
        remapped = [line for line in _scrape(c).splitlines()
                    if line.startswith("ceph_remap_last_pgs_remapped")]
        assert remapped and float(remapped[0].split()[-1]) > 0
        # restore for the next test
        c.mon_command({"prefix": "osd in", "id": 3})
        assert _wait(lambda: c.mgr.mc.osdmap.is_in(3), 10.0)
        pm.scan()

    def test_pg_imbalance_raises_and_clears(self, obs_cluster):
        c = obs_cluster
        pm = c.mgr.module("placement")
        d0 = pm.scan()["max_deviation"]

        def checks() -> dict:
            rv, st = c.mon_command({"prefix": "status"})
            assert rv == 0
            return (st.get("health") or {}).get("checks") or {}

        # threshold above the current skew: no check
        c.mgr.cct.conf.set("mgr_placement_max_deviation", d0 + 5.0)
        pm.scan()
        assert _wait(lambda: "PG_IMBALANCE" not in checks(), 10.0)
        # threshold below the current skew, balancer off: check raises
        c.mgr.cct.conf.set("mgr_placement_max_deviation", max(0.1, d0 - 0.5))
        assert _wait(lambda: "PG_IMBALANCE" in checks(), 10.0)
        chk = checks()["PG_IMBALANCE"]
        assert "plc" in chk["pools"] and chk["detail"]
        # an active pass improves the exported score and the deviation
        # converges under a bound the balancer can reach — the check clears
        c.mgr.cct.conf.set("mgr_balancer_active", True)
        bal = c.mgr.module("balancer")
        bal.optimize_once()
        st = bal.status()
        lp = st["last_pass"]
        assert lp["score_after"]["score"] <= lp["score_before"]["score"]
        assert st["balancer_errors"] == 0, st["last_error"]
        assert _wait(lambda: c.mgr.mc.osdmap.pg_upmap_items
                     or not bal.last_result, 10.0)
        pm.scan()
        d1 = pm.scan()["max_deviation"]
        assert d1 <= d0
        c.mgr.cct.conf.set("mgr_placement_max_deviation", d1 + 0.5)
        pm.scan()
        assert _wait(lambda: "PG_IMBALANCE" not in checks(), 10.0)
        c.mgr.cct.conf.set("mgr_balancer_active", False)

    def test_dump_kernel_telemetry_lists_the_device(self, obs_cluster):
        from ceph_tpu_torch.common.kernel_telemetry import (
            SENTINEL, dump_kernel_telemetry, probe_device_rows)

        rows = probe_device_rows()
        # no card here: the one row is the CPU the cluster runs on
        assert [r["device"] for r in rows] == [f"{obs_cluster.device.type}:0"]
        assert all(r["ok"] and r["latency_ms"] >= 0.0 for r in rows)
        SENTINEL.probe_once()
        dump = dump_kernel_telemetry()
        assert {r["device"] for r in dump["devices"]} == {r["device"] for r in rows}
        # after a probe, the per-device rows render as labeled series (the
        # next OSD perf report carries them)
        assert _wait(lambda: "ceph_backend_device_ok" in _scrape(obs_cluster), 10.0)
        body = _scrape(obs_cluster)
        assert "ceph_backend_device_probe_ms" in body
        assert f'device="{rows[0]["device"]}"' in body


# ---- qa/recovery_smoke.py on the CPU -------------------------------------


def test_recovery_smoke_on_the_cpu(capsys):
    """The port's cephheal smoke: k + m = 3 OSDs with the mgr hosted, two
    writers, a kill under the failure detector's default grace, a revive
    and drain, the prometheus series and a tail-promoted trace."""
    import json

    from ceph_tpu_torch.qa import recovery_smoke

    rc = recovery_smoke.main(["--device", "cpu"])
    summary = json.loads(capsys.readouterr().out)
    assert rc == 0, summary["problems"]
    assert summary["problems"] == [] and summary["completed_events"] >= 1
