"""The port's cluster against the reference's, on the CPU.

A reference ``LocalCluster`` with ``plugin=jax`` pools and a port
``LocalCluster(device="cpu")`` with ``plugin=torch`` pools (one monitor,
six OSDs, one per host bucket), each with an RS(4,2) cauchy_good pool
and a CLAY(4,2,d=5) pool, go through the same steps: writes, a ranged
RMW overwrite across shards, appends, full and ranged degraded reads
with one OSD killed, recovery of an OSD that comes back empty, a CLAY
planned repair and a deep scrub that repairs a corrupted shard.  Each
test compares one step's results: the objects a client reads and every
shard in every OSD's store.  Objects of 64-256 KiB come from
``np.random.default_rng(SEED)``.  Tolerance: byte equality.

The port side also asserts which path ran, since equal bytes alone would
not show it: writes went through the write batcher's flush (K1's route
on the card), ranged degraded reads through the read batcher's windowed
decode, and a CLAY rebuild through the planned repair apply, whose
failure fails the rebuild instead of finishing on the broad-gather
decode.

The two clusters run one after the other, each through every step, in a
module fixture: an idle cluster's recovery ticks keep most of a core
busy, and two at once in one interpreter slow each op tenfold.  A step
that raises is recorded and raised again by its test.
"""
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu.common.kernel_telemetry import TELEMETRY as REF_TELEMETRY
from ceph_tpu.osd.osdmap import object_ps as ref_object_ps
from ceph_tpu.qa.vstart import LocalCluster as RefCluster
from ceph_tpu.store.object_store import Transaction as RefTransaction
from ceph_tpu_torch.common.context import CephContext
from ceph_tpu_torch.common.kernel_telemetry import TELEMETRY
from ceph_tpu_torch.ops import bitplane
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.osd.osdmap import object_ps
from ceph_tpu_torch.qa.vstart import LocalCluster
from ceph_tpu_torch.store.object_store import Transaction

pytestmark = pytest.mark.cluster

SEED = 20261017
K, M, D = 4, 2, 5
RS, CLAY = "rs", "clay"
POOLS = (RS, CLAY)
PG_NUM = 8
#: a killed OSD is noticed by its primaries' sub-op timeouts (s); the
#: monitor's failure detector is held off, since an OSD that comes back
#: is otherwise marked down again by its peers' late failure reports
CONF = {"osd_subop_reply_timeout": 1.5, "osd_heartbeat_grace": 600.0}

#: the two packages, each with what its steps need of it
PACKAGES = {
    "ref": SimpleNamespace(cluster=lambda: RefCluster(
        n_mons=1, n_osds=K + M, conf_overrides=CONF), plugin="jax",
        object_ps=ref_object_ps, Transaction=RefTransaction,
        telemetry=REF_TELEMETRY),
    "port": SimpleNamespace(cluster=lambda: LocalCluster(
        n_mons=1, n_osds=K + M, conf_overrides=CONF, device="cpu"),
        plugin="torch", object_ps=object_ps, Transaction=Transaction,
        telemetry=TELEMETRY),
}


def _objects(tag: str, n: int) -> dict[str, bytes]:
    rng = np.random.default_rng([SEED, sum(map(ord, tag))])
    sizes = rng.integers(64 << 10, 256 << 10, n)
    return {f"{tag}{i}": rng.integers(0, 256, int(s), np.uint8).tobytes()
            for i, s in enumerate(sizes)}


class Side:
    """One package's cluster and a client handle on each pool."""

    def __init__(self, name: str, cluster):
        self.name = name
        self.pkg = PACKAGES[name]
        self.c = cluster
        for pool, extra in ((RS, {"technique": "cauchy_good"}), (CLAY, {"d": str(D)})):
            cluster.create_ec_pool(pool, k=K, m=M, pg_num=PG_NUM,
                                   plugin=self.pkg.plugin if pool == RS else "clay",
                                   extra_profile=extra)
        self.client = cluster.client()
        self.io = {p: self.client.open_ioctx(p) for p in POOLS}

    def osdmap(self):
        return self.c._leader().osdmon.osdmap

    def pid(self, pool: str) -> int:
        return self.client.pool_id(pool)

    def ps(self, oid: str) -> int:
        return self.pkg.object_ps(oid, PG_NUM)

    def acting(self, pool: str, oid: str) -> tuple[list[int], int]:
        _up, _upp, acting, primary = self.osdmap().pg_to_up_acting_osds(
            self.pid(pool), self.ps(oid))
        return acting, primary

    def shards(self, pool: str, osds=None) -> dict[tuple, bytes]:
        """(osd, collection, oid) -> the stored shard bytes of every
        object of `pool` (PG metadata objects left out)."""
        pid = self.pid(pool)
        out = {}
        for i, osd in sorted(self.c.osds.items()):
            if osds is not None and i not in osds:
                continue
            for cid in osd.store.list_collections():
                if not cid.startswith(f"{pid}."):
                    continue
                for oid in osd.store.list_objects(cid):
                    if not oid.startswith("_"):
                        out[(i, cid, oid)] = bytes(osd.store.read(cid, oid))
        return out

    def recovery_rows(self, skip=()) -> dict[str, dict]:
        """Repair-bandwidth accounting summed over the live OSDs (less
        `skip`), by codec."""
        agg: dict[str, dict] = {}
        for i, osd in self.c.osds.items():
            if i in skip:
                continue
            rec = osd.cct.perf.dump().get("recovery", {})
            for row in (rec.get("per_pool") or {}).get("rows", []):
                e = agg.setdefault(row["labels"]["codec"], dict.fromkeys(
                    ("repairs", "helper_reads", "full_gathers"), 0))
                for f in e:
                    e[f] += row[f]
        return agg

    def stats(self, attr: str) -> dict[str, int]:
        """One batcher's stats summed over the live OSDs."""
        out: dict[str, int] = {}
        for osd in self.c.osds.values():
            for f, v in getattr(osd, attr).stats().items():
                out[f] = out.get(f, 0) + v
        return out

    def write(self, pool: str, objs: dict[str, bytes]) -> None:
        for oid, data in objs.items():
            self.io[pool].write_full(oid, data)

    def wipe_and_revive(self, victim: int) -> None:
        """Kill `victim`, drop its store (a replaced disk) and boot it
        empty; recovery backfills every shard it held."""
        self.c.kill_osd(victim)
        self.c._stores.pop(victim)
        self.c.revive_osd(victim)

    def wait_clean(self) -> None:
        for p in POOLS:
            self.c.wait_clean(p, timeout=60)


def _wait(cond, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


# -- the steps: each runs on one side and returns what the tests compare --

STEPS = {}
#: steps that only the port runs
PORT_ONLY = set()


def step(fn=None, *, port_only: bool = False):
    def add(fn):
        STEPS[fn.__name__] = fn
        if port_only:
            PORT_ONLY.add(fn.__name__)
        return fn

    return add(fn) if fn is not None else add


@step
def osdmap_json(side: Side) -> dict:
    # through JSON text: to_json shares the map's own dicts
    return json.loads(json.dumps(side.osdmap().to_json()))


def _write_and_read(side: Side, pool: str) -> dict:
    objs = _objects(f"w{pool}", 6)
    wb0 = side.stats("write_batcher")
    side.write(pool, objs)
    for oid, data in objs.items():
        assert side.io[pool].read(oid) == data, (side.name, oid)
    wb = side.stats("write_batcher")
    return {"shards": side.shards(pool), "n": len(objs),
            "wb": {f: wb[f] - wb0.get(f, 0) for f in wb}}


@step
def write_and_read_rs(side: Side) -> dict:
    return _write_and_read(side, RS)


@step
def write_and_read_clay(side: Side) -> dict:
    return _write_and_read(side, CLAY)


def _rmw(side: Side, pool: str) -> dict:
    objs = _objects(f"m{pool}", 2)
    side.write(pool, objs)
    rng = np.random.default_rng([SEED, 7])
    for oid, data in objs.items():
        L = -(-len(data) // K)
        off = L - 1000  # from the end of chunk 0 into chunk 1
        patch = rng.integers(0, 256, 3000, np.uint8).tobytes()
        side.io[pool].write(oid, patch, off=off)
        want = data[:off] + patch + data[off + len(patch):]
        assert side.io[pool].read(oid) == want, (side.name, oid)
    return {"shards": side.shards(pool)}


@step
def rmw_rs(side: Side) -> dict:
    return _rmw(side, RS)


@step
def rmw_clay(side: Side) -> dict:
    return _rmw(side, CLAY)


def _append(side: Side, pool: str) -> dict:
    objs = _objects(f"a{pool}", 2)
    side.write(pool, objs)
    tail = np.random.default_rng([SEED, 9]).integers(0, 256, 70_000, np.uint8).tobytes()
    for oid, data in objs.items():
        side.io[pool].append(oid, tail)
        assert side.io[pool].read(oid) == data + tail, (side.name, oid)
    return {"shards": side.shards(pool)}


@step
def append_rs(side: Side) -> dict:
    return _append(side, RS)


@step
def append_clay(side: Side) -> dict:
    return _append(side, CLAY)


@step
def degraded_reads(side: Side) -> dict:
    """Kill an OSD that holds a data shard of the first RS object (not
    its primary) and read every object whole and in ranges.  The range
    inside the victim's chunk must decode only its column window."""
    objs = {p: _objects(f"d{p}", 3) for p in POOLS}
    for p in POOLS:
        side.write(p, objs[p])
    first = next(iter(objs[RS]))
    acting, primary = side.acting(RS, first)
    victim = next(acting[j] for j in range(K) if acting[j] >= 0 and acting[j] != primary)
    shard = acting.index(victim)
    rb0 = side.stats("read_batcher")

    def decoded_in() -> int:
        return side.pkg.telemetry.dump().get("read_batch_decode", {}).get("bytes_in", 0)

    side.c.kill_osd(victim)
    try:
        for p in POOLS:
            for oid, data in objs[p].items():
                assert side.io[p].read(oid) == data, (side.name, p, oid)
        data = objs[RS][first]
        L = -(-len(data) // K)
        off, ln = shard * L + 37, 1001
        b0 = decoded_in()
        assert side.io[RS].read(first, off=off, length=ln) == data[off:off + ln]
        ranged_in = decoded_in() - b0
        for oid, data in objs[CLAY].items():
            assert side.io[CLAY].read(oid, off=777, length=5555) == data[777:6332]
        rb = side.stats("read_batcher")
    finally:
        side.c.revive_osd(victim)
    side.wait_clean()
    return {"victim": victim, "ranged_in": ranged_in, "window": ln,
            "decode_groups": rb["decode_groups"] - rb0.get("decode_groups", 0)}


@step
def recovery_after_kill_and_revive(side: Side) -> dict:
    """OSD 1 comes back with an empty store: recovery rebuilds every
    shard it held, byte-equal to what it held before."""
    for p in POOLS:
        side.write(p, _objects(f"r{p}", 3))
    before = {p: side.shards(p, {1}) for p in POOLS}
    side.wipe_and_revive(1)
    side.wait_clean()
    return {"before": before, "after": {p: side.shards(p, {1}) for p in POOLS}}


@step
def clay_planned_repair(side: Side) -> dict:
    """OSD 4 comes back empty: its CLAY shards are rebuilt on the plan
    path, d helpers' repair planes each."""
    r0 = side.recovery_rows().get("clay", {})
    side.wipe_and_revive(4)
    side.wait_clean()
    row = side.recovery_rows()["clay"]
    return {"delta": {f: row[f] - r0.get(f, 0) for f in row},
            "shards": side.shards(CLAY)}


@step
def deep_scrub_repairs(side: Side) -> dict:
    """A flipped byte in one stored shard (not the primary's): a deep
    scrub of its PG reports and repairs it."""
    objs = _objects("s", 1)
    side.write(RS, objs)
    oid, data = next(iter(objs.items()))
    clean = side.shards(RS)
    acting, primary = side.acting(RS, oid)
    bad = next(o for o in acting if o >= 0 and o != primary)
    cid = f"{side.pid(RS)}.{side.ps(oid)}s{acting.index(bad)}"
    store = side.c.osds[bad].store
    orig = bytes(store.read(cid, oid))
    tx = side.pkg.Transaction()
    tx.write(cid, oid, 0, bytes([orig[0] ^ 0xFF]) + orig[1:])
    store.queue_transaction(tx)
    report = side.io[RS].scrub_pg(side.ps(oid))
    assert report.get("repaired"), (side.name, report)
    assert bytes(store.read(cid, oid)) == orig, side.name
    assert not side.io[RS].scrub_pg(side.ps(oid)).get("inconsistent"), side.name
    assert side.io[RS].read(oid) == data
    return {"clean": clean, "after": side.shards(RS)}


@step(port_only=True)
def failed_repair_apply(side: Side) -> dict:
    """The GF apply of recovery's planned CLAY repair raises while OSD 3
    comes back empty (the codec's own applies, which a broad-gather
    decode would use, keep working); then it works again and recovery
    finishes."""
    real = bitplane.apply_matrix
    calls = []

    def failing(mat, chunks, device=None, mat_key=None):
        if sys._getframe(1).f_code.co_filename.endswith(os.path.join("osd", "recovery.py")):
            calls.append(np.asarray(mat).shape)
            raise RuntimeError("injected: GF apply failed")
        return real(mat, chunks, device=device, mat_key=mat_key)

    def errors() -> int:
        return sum(o.logger.get("recovery_errors") for o in side.c.osds.values())

    def gathers() -> int:
        # the returning OSD is left out: its counters start over, and it
        # rebuilds its own shards (as primary) by the broad gather anyway
        return side.recovery_rows(skip={3}).get("clay", {}).get("full_gathers", 0)

    gathers0, e0 = gathers(), errors()
    bitplane.apply_matrix = failing
    try:
        side.wipe_and_revive(3)
        counted = _wait(lambda: errors() > e0, timeout=20)
        failures = [f[1] for o in side.c.osds.values()
                    for f in o._recovery_failures.values()]
        gathers_during = gathers() - gathers0
    finally:
        bitplane.apply_matrix = real
    side.wait_clean()
    return {"counted": counted, "calls": len(calls), "failures": failures,
            "gathers_during": gathers_during}


@step(port_only=True)
def profile_without_plugin(side: Side) -> dict:
    rv, res = side.c.mon_command({
        "prefix": "osd erasure-code-profile set", "name": "noplugin",
        "profile": {"k": "2", "m": "1"}})
    return {"rv": rv, "res": res,
            "plugin": side.osdmap().ec_profiles.get("noplugin", {}).get("plugin"),
            "devices": {str(o.device) for o in side.c.osds.values()}}


@pytest.fixture(scope="module")
def runs():
    out: dict[str, dict] = {}
    for name, pkg in PACKAGES.items():
        rec = out[name] = {}
        cluster = pkg.cluster().start()
        try:
            side = Side(name, cluster)
            for sname, fn in STEPS.items():
                if name == "ref" and sname in PORT_ONLY:
                    continue
                try:
                    rec[sname] = fn(side)
                except Exception as e:  # raised again by the step's test
                    rec[sname] = e
        finally:
            cluster.stop()
    return out


def _results(runs, name: str):
    """(reference, port) results of one step; a step's failure is raised."""
    got = runs["ref"].get(name), runs["port"][name]
    for r in got:
        if isinstance(r, BaseException):
            raise r
    return got


# -- the tests --------------------------------------------------------------

def test_osdmap_json_agrees(runs):
    """Both clusters build the same map: crush, pools, rules, OSD
    states; the EC profiles differ only in the plugin name.  Left out:
    the OSDs' localhost ports and the epoch, whose count of boot-time
    map changes depends on thread timing."""
    ref, port = _results(runs, "osdmap_json")
    assert port["ec_profiles"][f"{RS}_profile"]["plugin"] == "torch"
    for d in (ref, port):
        d.pop("epoch")
        for prof in d["ec_profiles"].values():
            prof.pop("plugin")
        for addr in d["osd_addrs"]:
            addr.pop("port")
    assert port == ref


def _same_shards(ref: dict, port: dict) -> None:
    assert set(port) == set(ref)
    bad = [k for k in ref if port[k] != ref[k]]
    assert not bad, f"shards differ from the reference's: {bad[:4]}"


@pytest.mark.parametrize("pool", POOLS)
def test_write_and_read(runs, pool):
    ref, port = _results(runs, f"write_and_read_{pool}")
    _same_shards(ref["shards"], port["shards"])
    assert len(port["shards"]) >= port["n"] * (K + M)
    wb = port["wb"]
    assert wb["inline"] == 0
    if pool == RS:
        # every RS write's parity came out of a write-batcher flush, none
        # was encoded inline in the codec
        assert wb["flushes"] > 0
        assert wb["stripes"] == port["n"]


@pytest.mark.parametrize("pool", POOLS)
def test_ranged_rmw_overwrite_crosses_shards(runs, pool):
    """An overwrite from one data chunk into the next: the RS pool takes
    the parity-delta RMW, CLAY the full re-encode."""
    ref, port = _results(runs, f"rmw_{pool}")
    _same_shards(ref["shards"], port["shards"])


@pytest.mark.parametrize("pool", POOLS)
def test_append(runs, pool):
    ref, port = _results(runs, f"append_{pool}")
    _same_shards(ref["shards"], port["shards"])


def test_degraded_reads(runs):
    """Full and ranged degraded reads came back exact on both sides
    (checked in the step); the range inside one chunk decoded k x window
    bytes, not k x L, and on the port in the read batcher's grouped
    decode."""
    ref, port = _results(runs, "degraded_reads")
    assert port["victim"] == ref["victim"]
    for r in (ref, port):
        assert r["ranged_in"] == K * r["window"], r
    assert port["decode_groups"] > 0


def test_recovery_after_kill_and_revive(runs):
    ref, port = _results(runs, "recovery_after_kill_and_revive")
    for p in POOLS:
        assert port["before"][p], p
        assert port["after"][p] == port["before"][p], p
        _same_shards(ref["after"][p], port["after"][p])


def test_clay_planned_repair(runs):
    """Each CLAY rebuild read d helpers, on the plan path, on both
    sides alike."""
    ref, port = _results(runs, "clay_planned_repair")
    d = port["delta"]
    assert d["repairs"] > 0
    assert d["helper_reads"] == D * d["repairs"], d
    assert d["full_gathers"] == 0, d
    assert d == ref["delta"]
    _same_shards(ref["shards"], port["shards"])


def test_deep_scrub_repairs_corrupt_shard(runs):
    ref, port = _results(runs, "deep_scrub_repairs")
    assert port["after"] == port["clean"]
    _same_shards(ref["after"], port["after"])


def test_failed_repair_apply_fails_the_rebuild(runs):
    """A failure raised by the GF apply during a CLAY planned repair
    fails that rebuild: the OSD logs and counts it, and the rebuild does
    not finish through the broad-gather decode."""
    _ref, got = _results(runs, "failed_repair_apply")
    assert got["calls"] > 0
    assert got["counted"], "no recovery error counted"
    assert any("injected: GF apply failed" in f for f in got["failures"])
    assert got["gathers_during"] == 0


def test_profile_defaults_to_torch_on_the_cluster_device(runs):
    """A profile without a plugin is validated by building the torch
    codec on the monitor's device (cpu here: on a host without a card a
    build on cuda would raise)."""
    _ref, got = _results(runs, "profile_without_plugin")
    assert got["rv"] == 0, got["res"]
    assert got["plugin"] == "torch"
    assert got["devices"] == {"cpu"}


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        LocalCluster(with_mgr=True, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        LocalCluster(with_mds=True, device="cpu")
    osd = OSD.__new__(OSD)
    osd.cct = CephContext("osd.0", overrides={"ec_kernel": "oracle"}, device="cpu")
    osd._codecs = {}

    class _Map:
        ec_profiles = {"p": {"k": "2", "m": "1"}}

    class _Pool:
        ec_profile = "p"

    osd.osdmap = _Map()
    osd.device = "cpu"
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        osd._codec_for_pool(_Pool())


def test_cluster_without_a_card_raises(monkeypatch):
    """No path runs on the CPU unless asked for: without a card the
    default device is cuda, which raises before any daemon starts."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalCluster(n_mons=1, n_osds=1)


def test_first_command_waits_out_an_election():
    """A leader that calls an election keeps its rank and answers -307
    naming itself until a leader is elected.  A command that meets it
    waits and then runs; counting those instant NACKs as attempts gave
    up with -110 within a second."""
    import threading

    from ceph_tpu_torch.mon.monitor import STATE_LEADER

    c = LocalCluster(n_mons=3, n_osds=1, device="cpu").start()
    try:
        leader = c._leader()
        leader.set_electing()

        def elected():
            with leader._state_lock:
                leader.state = STATE_LEADER

        timer = threading.Timer(1.5, elected)
        timer.start()
        t0 = time.monotonic()
        rv, res = c.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "p",
            "profile": {"plugin": "torch", "k": "2", "m": "1"}})
        timer.join()
        assert rv == 0, res
        assert time.monotonic() - t0 >= 1.4
    finally:
        c.stop()


def test_osds_share_placements_by_map_content():
    """The OSDs of one process share placements keyed by the map's
    placement inputs: a new epoch that moves no PG (here a profile) maps
    to the same placements, a map with an OSD down to others, and every
    shared placement equals the map's own pg_to_up_acting_osds."""
    from ceph_tpu_torch.crush import CrushWrapper, build_hierarchical_map
    from ceph_tpu_torch.osd import daemon
    from ceph_tpu_torch.osd.osdmap import OSDMap

    m = OSDMap(CrushWrapper(build_hierarchical_map(6, 2)), device="cpu")
    m.create_pool(1, pg_num=16, size=3, crush_rule=0, name="rbd")
    later = OSDMap.from_json(m.to_json(), device="cpu")
    later.epoch += 1
    later.ec_profiles["p"] = {"k": "2", "m": "1"}
    down = OSDMap.from_json(m.to_json(), device="cpu")
    down.mark_down(int(m.pg_to_up_acting_osds(1, 0)[0][0]))

    shared = daemon._placements_of(m)
    assert daemon._placements_of(later) is shared
    assert daemon._placements_of(down) is not shared
    for mm in (m, later, down):
        memo = (mm, daemon._placements_of(mm))
        for ps in range(16):
            up, up_p, acting, acting_p = mm.pg_to_up_acting_osds(1, ps)
            assert daemon._placed(memo, 1, ps) == (tuple(up), up_p, tuple(acting), acting_p)
