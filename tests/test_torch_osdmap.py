"""The port's OSDMap, balancer, osdmaptool, PG log and past intervals
against the reference's: the cases of tests/test_osdmap.py, the
osdmaptool transcripts of tests/test_tools.py and the pure PastIntervals
and PGLog cases, through both packages with the same maps.

The port maps with ``device="cpu"`` (the plain version of K3); its
map_pool must equal the reference's map_pool (the JAX batch mapper on the
CPU) and the scalar pg_to_up_acting_osds, on replicated and EC pools,
with OSDs down or out, pg_upmap, pg_upmap_items, pg_temp and primary
affinity.  calc_pg_upmaps must make the same changes, an OSDMap JSON
written by one package must load in the other, and osdmaptool must print
the same text.  The reference's batch mapper compiles for seconds per
rule shape, so the cases share the maps' shapes.  (The cluster cases of
tests/test_past_intervals.py wait for the cluster slice.)
"""
import io
import json

import numpy as np
import pytest

from ceph_tpu import crush as ref_crush
from ceph_tpu import osd as ref_osd
from ceph_tpu.osd import past_intervals as ref_pi
from ceph_tpu.osd import pg as ref_pg
from ceph_tpu.osd import pg_log as ref_pg_log
from ceph_tpu.osd.balancer import rule_osd_info as ref_rule_osd_info
from ceph_tpu.tools import osdmaptool as ref_tool
from ceph_tpu_torch import crush as port_crush
from ceph_tpu_torch import osd as port_osd
from ceph_tpu_torch.crush import ITEM_NONE
from ceph_tpu_torch.osd import past_intervals as port_pi
from ceph_tpu_torch.osd import pg as port_pg
from ceph_tpu_torch.osd import pg_log as port_pg_log
from ceph_tpu_torch.osd.balancer import rule_osd_info
from ceph_tpu_torch.tools import osdmaptool as port_tool


def make_map(crush, osd, device=None):
    """tests/test_osdmap.py's map: 8 hosts x 4 OSDs, a size-3 replicated
    pool of 64 PGs and a size-6 EC pool of 32."""
    kw = {} if device is None else {"device": device}
    m = osd.OSDMap(crush.CrushWrapper(crush.build_hierarchical_map(8, 4)), **kw)
    m.create_pool(1, pg_num=64, size=3, crush_rule=0, name="rbd")
    m.create_pool(2, pg_num=32, size=6, crush_rule=1, type=osd.PG_POOL_ERASURE)
    return m


def pair():
    return make_map(ref_crush, ref_osd), make_map(port_crush, port_osd, "cpu")


def scalar_table(m, pid):
    return [m.pg_to_up_acting_osds(pid, ps) for ps in range(m.pools[pid].pg_num)]


def assert_parity(ref, port, pid):
    """The port's map_pool equals the reference's and the port's scalar
    mapping; the scalar mappings of both packages are equal."""
    up, prim = port.map_pool(pid)
    rup, rprim = ref.map_pool(pid)
    np.testing.assert_array_equal(up, np.asarray(rup))
    np.testing.assert_array_equal(prim, np.asarray(rprim))
    assert up.dtype == np.int32 and prim.dtype == np.int32
    table = scalar_table(port, pid)
    assert table == scalar_table(ref, pid)
    size = port.pools[pid].size
    for ps, (u, upp, _, _) in enumerate(table):
        assert up[ps].tolist() == (u + [ITEM_NONE] * size)[:size], ps
        assert prim[ps] == upp, ps


# ---- ceph_stable_mod and the PG mapping (tests/test_osdmap.py) ----


def test_stable_mod_matches_reference():
    for b in (1, 3, 8, 12, 100, 4096):
        mask = port_osd.pg_num_mask(b)
        assert mask == ref_osd.pg_num_mask(b)
        got = [port_osd.ceph_stable_mod(x, b, mask) for x in range(4 * b)]
        assert got == [ref_osd.ceph_stable_mod(x, b, mask) for x in range(4 * b)]
        assert all(0 <= r < b for r in got)
    for b in (4, 8, 16):  # doubling pg_num splits each PG into {p, p + b}
        for x in range(1000):
            r1 = port_osd.ceph_stable_mod(x, b, port_osd.pg_num_mask(b))
            assert port_osd.ceph_stable_mod(x, 2 * b, port_osd.pg_num_mask(2 * b)) in (r1, r1 + b)


def _scalar_basics(m):
    for ps in range(m.pools[1].pg_num):
        up, upp, acting, actp = m.pg_to_up_acting_osds(1, ps)
        assert len(up) == 3 and len({o // 4 for o in up}) == 3
        assert upp == up[0] and acting == up and actp == upp
    return scalar_table(m, 1)


def _ec_positional_holes(m):
    up, _, _, _ = m.pg_to_up_acting_osds(2, 0)
    m.mark_down(up[2])
    up2, _, _, _ = m.pg_to_up_acting_osds(2, 0)
    assert up2[2] == ITEM_NONE
    assert [o for i, o in enumerate(up2) if i != 2] == [o for i, o in enumerate(up) if i != 2]
    return up, up2


def _replicated_compacts_down_osds(m):
    up, _, _, _ = m.pg_to_up_acting_osds(1, 5)
    m.mark_down(up[0])
    up2, upp2, _, _ = m.pg_to_up_acting_osds(1, 5)
    assert up[0] not in up2 and len(up2) == 2 and upp2 == up2[0]
    return up, up2


def _out_osd_remapped(m):
    up, _, _, _ = m.pg_to_up_acting_osds(1, 7)
    m.mark_out(up[1])
    up2, _, _, _ = m.pg_to_up_acting_osds(1, 7)
    assert up[1] not in up2 and len(up2) == 3
    return up, up2


def _pg_upmap_full_override(m):
    m.pg_upmap[(1, 3)] = [0, 4, 8]
    up = m.pg_to_up_acting_osds(1, 3)[0]
    assert up == [0, 4, 8]
    return up


def _pg_upmap_items(m):
    up = m.pg_to_up_acting_osds(1, 9)[0]
    to = next(o for o in range(m.max_osd) if o // 4 not in {x // 4 for x in up})
    m.pg_upmap_items[(1, 9)] = [(up[1], to)]
    up2 = m.pg_to_up_acting_osds(1, 9)[0]
    assert to in up2 and up[1] not in up2
    return up2


def _pg_upmap_items_on_top_of_pg_upmap(m):
    m.pg_upmap[(1, 3)] = [0, 4, 8]
    m.pg_upmap_items[(1, 3)] = [(0, 12)]
    up = m.pg_to_up_acting_osds(1, 3)[0]
    assert up == [12, 4, 8] and list(m.map_pool(1)[0][3]) == up
    return up


def _upmap_to_out_osd_ignored(m):
    up = m.pg_to_up_acting_osds(1, 9)[0]
    to = next(o for o in range(m.max_osd) if o not in up)
    m.mark_out(to)
    m.pg_upmap_items[(1, 9)] = [(up[0], to)]
    up2 = m.pg_to_up_acting_osds(1, 9)[0]
    assert to not in up2
    return up2


def _oversized_pg_upmap_ignored(m):
    plain = m.pg_to_up_acting_osds(1, 3)
    m.pg_upmap[(1, 3)] = [0, 4, 8, 12]
    assert m.pg_to_up_acting_osds(1, 3) == plain
    assert list(m.map_pool(1)[0][3]) == plain[0]
    return plain


def _pg_temp(m):
    m.pg_temp[(1, 0)] = [1, 2, 3]
    m.primary_temp[(1, 0)] = 2
    _, _, acting, actp = m.pg_to_up_acting_osds(1, 0)
    assert acting == [1, 2, 3] and actp == 2
    return acting, actp


def _primary_affinity_zero_skips(m):
    up, upp, _, _ = m.pg_to_up_acting_osds(1, 11)
    m.set_primary_affinity(upp, 0.0)
    upp2 = m.pg_to_up_acting_osds(1, 11)[1]
    assert upp2 != upp and upp2 in up
    return upp, upp2


def _primary_affinity_all_zero_falls_back(m):
    up = m.pg_to_up_acting_osds(1, 11)[0]
    for o in up:
        m.set_primary_affinity(o, 0.0)
    upp2 = m.pg_to_up_acting_osds(1, 11)[1]
    assert upp2 == up[0]
    return upp2


@pytest.mark.parametrize("case", [
    _scalar_basics, _ec_positional_holes, _replicated_compacts_down_osds,
    _out_osd_remapped, _pg_upmap_full_override, _pg_upmap_items,
    _pg_upmap_items_on_top_of_pg_upmap, _upmap_to_out_osd_ignored,
    _oversized_pg_upmap_ignored, _pg_temp, _primary_affinity_zero_skips,
    _primary_affinity_all_zero_falls_back,
], ids=lambda f: f.__name__[1:])
def test_pg_mapping_case_matches_reference(case):
    ref, port = pair()
    assert case(port) == case(ref)
    assert port.epoch == ref.epoch
    for pid in (1, 2):
        assert_parity(ref, port, pid)


# ---- map_pool against the reference and the scalar mapping ----


def _failures_and_overrides(m):
    m.mark_down(3)
    m.mark_out(17)
    m.set_primary_affinity(5, 0.25)
    m.set_primary_affinity(9, 0.0)
    m.pg_upmap[(1, 3)] = [0, 4, 8]
    m.pg_upmap[(2, 6)] = [1, 5, 9, 13, 21, 25]
    up = m.pg_to_up_acting_osds(1, 20)[0]
    to = next(o for o in range(m.max_osd) if o // 4 not in {x // 4 for x in up})
    m.pg_upmap_items[(1, 20)] = [(up[1], to)]
    m.pg_upmap_items[(2, 11)] = [(m.pg_to_up_acting_osds(2, 11)[0][0], 30)]
    m.pg_temp[(1, 5)] = [1, 2, 3]
    m.pg_temp[(2, 7)] = [4, 8, 12, 16, 20, 24]
    m.primary_temp[(1, 5)] = 2


def _host_out(m):
    for o in range(4, 8):  # host1
        m.mark_out(o)
    m.mark_down(22)


STATES = {"plain": lambda m: None, "failures_and_overrides": _failures_and_overrides,
          "host_out": _host_out}


@pytest.mark.parametrize("pid", [1, 2], ids=["replicated", "erasure"])
@pytest.mark.parametrize("state", list(STATES))
def test_map_pool_matches_reference_and_scalar(state, pid):
    ref, port = pair()
    STATES[state](ref)
    STATES[state](port)
    assert_parity(ref, port, pid)
    if state == "host_out":
        up, _ = port.map_pool(pid)
        assert not np.isin(up, [4, 5, 6, 7, 22]).any()


def test_map_pool_device():
    """map_pool runs on the map's device: "cpu" here; without a device
    the map asks for the card, and without one it raises."""
    _, port = pair()
    port.map_pool(1)
    assert port.device.type == "cpu"
    bare = make_map(port_crush, port_osd)
    assert bare.device is None
    blob = bare.to_json()
    assert "device" not in blob
    assert port_osd.OSDMap.from_json(blob, device="cpu").device == "cpu"
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bare.map_pool(1)


# ---- JSON across packages ----


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_osdmap_json_crosses_packages(writer):
    ref, port = pair()
    for m in (ref, port):
        _failures_and_overrides(m)
        m.flags.add("noout")
        m.osd_addrs[3] = ("127.0.0.1", 6803)
        m.ec_profiles["rs84"] = {"plugin": "jax", "k": "8", "m": "4"}
        m.auth_gens["osd"] = 2
    assert json.dumps(port.to_json()) == json.dumps(ref.to_json())
    src = ref if writer == "reference" else port
    blob = json.loads(json.dumps(src.to_json()))
    loaded = {"reference": ref_osd.OSDMap.from_json(blob),
              "port": port_osd.OSDMap.from_json(blob, device="cpu")}
    for m in loaded.values():
        assert json.dumps(m.to_json()) == json.dumps(src.to_json())
    for pid in (1, 2):
        assert_parity(loaded["reference"], loaded["port"], pid)


# ---- the balancer ----


def test_rule_osd_info_matches_reference():
    ref, port = pair()
    for m in (ref, port):
        m.mark_out(6)
        m.mark_down(11)
    for rule in (0, 1):
        w, dom = rule_osd_info(port, rule)
        rw, rdom = ref_rule_osd_info(ref, rule)
        np.testing.assert_array_equal(w, rw)
        assert dom == rdom
    assert dom[0] == dom[3] and dom[0] != dom[4]  # host grouping


@pytest.mark.parametrize("pools", [[1], [2], [1, 2]], ids=["replicated", "erasure", "both"])
def test_calc_pg_upmaps_matches_reference(pools):
    ref, port = pair()
    for m in (ref, port):
        m.mark_out(13)
    before = port_osd.pool_pg_counts(port, pools)
    changes = port_osd.calc_pg_upmaps(port, max_deviation=1.0, pools=pools)
    assert changes == ref_osd.calc_pg_upmaps(ref, max_deviation=1.0, pools=pools)
    assert port.pg_upmap_items == ref.pg_upmap_items and port.epoch == ref.epoch
    after = port_osd.pool_pg_counts(port, pools)
    assert changes and after.sum() == before.sum()
    assert after.max() - after.min() < before.max() - before.min()
    for pid, ps, _frm, to in changes:  # every override is in effect
        assert to in port.pg_to_up_acting_osds(pid, ps)[0]
    for pid in pools:  # failure domains kept
        for up, *_ in scalar_table(port, pid):
            live = [o for o in up if o != ITEM_NONE]
            assert len({o // 4 for o in live}) == len(live)
    e1 = port.epoch
    assert not port_osd.calc_pg_upmaps(port, max_deviation=1.0, pools=pools)
    assert port.epoch == e1  # converged: no moves, no epoch
    for pid in pools:
        assert_parity(ref, port, pid)


def test_placement_reports_match_reference():
    ref, port = pair()
    for m in (ref, port):
        m.mark_out(2)
    from ceph_tpu.osd import placement as rp
    from ceph_tpu_torch.osd import placement as pp

    got, want = pp.cluster_report(port), rp.cluster_report(ref)
    for key in ("osd_counts", "osd_primaries", "osd_targets", "eligible"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("epoch", "max_deviation", "stddev", "score"):
        assert got[key] == want[key]
    prev = {pid: port.map_pool(pid)[0] for pid in (1, 2)}
    port.mark_out(9)
    ref_prev = {pid: ref.map_pool(pid)[0] for pid in (1, 2)}
    ref.mark_out(9)
    cur = {pid: port.map_pool(pid)[0] for pid in (1, 2)}
    ref_cur = {pid: ref.map_pool(pid)[0] for pid in (1, 2)}
    d, rd = pp.diff_mappings(port, prev, cur), rp.diff_mappings(ref, ref_prev, ref_cur)
    assert json.dumps(d, sort_keys=True, default=str) == json.dumps(rd, sort_keys=True, default=str)


# ---- osdmaptool transcripts (tests/test_tools.py) ----


def run(tool, argv):
    out = io.StringIO()
    rc = tool.main(argv, out=out)
    return rc, out.getvalue()


#: argv lists run in turn on one map file; "createsimple_dump" makes its
#: map with --createsimple, the others start from make_map's JSON as the
#: reference writes it
TRANSCRIPTS = {
    "createsimple_dump": [["--createsimple", "16"], ["--dump"], []],
    "test_map_pgs": [["--test-map-pgs", "--pool", "1"], ["--test-map-pgs"]],
    "upmap_stdout": [["--test-map-pgs", "--upmap", "-", "--upmap-deviation", "1"],
                     ["--upmap", "-", "--pool", "1"]],
    "upmap_file": [["--upmap", "{dir}/cmds.sh", "--pool", "2", "--upmap-max", "7"],
                   ["--dump", "--pool", "2"]],
    "errors": [["--test-map-pgs", "--pool", "9"]],
}


@pytest.mark.parametrize("name", list(TRANSCRIPTS))
def test_osdmaptool_prints_the_reference_text(name, tmp_path):
    start = json.dumps(make_map(ref_crush, ref_osd).to_json())
    outs = {}
    for pkg, tool, extra in (("reference", ref_tool, []),
                             ("port", port_tool, ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        mapfn = d / "osdmap.json"
        if name != "createsimple_dump":
            mapfn.write_text(start)
        steps = []
        for argv in TRANSCRIPTS[name]:
            argv = [a.format(dir=d) for a in argv]
            rc, out = run(tool, [str(mapfn), *argv]
                          + (extra if argv[:1] != ["--createsimple"] else []))
            steps.append((rc, out.replace(str(d), "DIR")))
        files = {f.name: f.read_text() for f in sorted(d.iterdir())}
        outs[pkg] = (steps, files)
    assert outs["port"] == outs["reference"]
    steps, files = outs["port"]
    assert all(rc == 0 for rc, _ in steps) or name == "errors"
    if name == "createsimple_dump":
        assert "writing epoch" in steps[0][1]
        assert "pool 1 'rbd' replicated size 3" in steps[1][1]
        assert "pool 2 'ecpool' erasure size 6" in steps[1][1]
        assert json.loads(files["osdmap.json"])["max_osd"] == 16
    if name == "test_map_pgs":
        counts = [int(ln.split("\t")[1]) for ln in steps[0][1].splitlines()
                  if ln.startswith("osd.")]
        assert "pool 1 pg_num 64" in steps[0][1] and sum(counts) == 64 * 3
        assert " size 192" in steps[0][1] and " size 384" in steps[1][1]
    if name == "upmap_stdout":
        assert "ceph osd pg-upmap-items 1." in steps[0][1]
        assert "0 upmap changes" in steps[1][1]  # the balanced map was saved back
    if name == "upmap_file":
        assert files["cmds.sh"].startswith("ceph osd pg-upmap-items 2.")
    if name == "errors":
        assert steps[0][0] == 1


def test_osdmaptool_device_option():
    with pytest.raises(SystemExit):
        port_tool.main(["x.json", "--device", "tpu"], out=io.StringIO())


# ---- PastIntervals and PGLog (pure cases) ----


def _pi(mod):
    pi = mod.PastIntervals()
    pi.add(1, 5, up=[0, 1], acting=[0, 1], primary=0, maybe_went_rw=True)
    pi.add(6, 9, up=[1, 2], acting=[1, 2], primary=1, maybe_went_rw=True)
    pi.add(10, 11, up=[2], acting=[2], primary=2, maybe_went_rw=False)
    return pi


def _pi_queries(mod):
    pi = _pi(mod)
    got = [pi.prior_holders(exclude=set()), pi.prior_holders(exclude={1}),
           pi.holders_of_shard(1, exclude=set()), pi.holders_of_shard(0, exclude=set()),
           pi.holders_of_shard(0, exclude={1}), pi.blocked_by({1}),
           [b["first"] for b in pi.blocked_by({0})], pi.blocked_by({0, 1})]
    assert got[:5] == [{1: 0, 2: 1, 0: 0}, {2: 1, 0: 0}, [2, 1], [1, 0], [0]]
    assert got[5] == [] and got[6] == [6] and got[7] == []
    wide = mod.PastIntervals()
    for i in range(10):
        wide.add(i * 2, i * 2 + 1, up=[i], acting=[i], primary=i, maybe_went_rw=True)
    c1 = wide.query_candidates(exclude=set(), is_up=lambda o: True, cap=3)
    c2 = wide.query_candidates(exclude=set(), is_up=lambda o: o % 2 == 0, cap=16)
    assert set(c1) == set(range(10)) and set(c2) == {0, 2, 4, 6, 8}
    return got + [c1, c2]


def _pi_serialization(mod):
    pi = _pi(mod)
    blob = pi.to_bytes()
    clone = mod.PastIntervals.from_bytes(blob)
    assert clone.intervals == pi.intervals
    assert mod.PastIntervals.from_bytes(None).intervals == []
    assert mod.PastIntervals.from_bytes(b"garbage{").intervals == []
    capped = mod.PastIntervals()
    for i in range(mod.MAX_INTERVALS + 10):
        capped.add(i, i, [0], [0], 0, True)
    assert len(capped) == mod.MAX_INTERVALS
    assert capped.intervals[-1]["first"] == mod.MAX_INTERVALS + 9
    return blob, capped.to_bytes()


def _pg_log(mod):
    log = mod.PGLog(limit=5)
    trimmed = []
    rng = np.random.default_rng(3)
    for v in range(1, 13):
        op = ["modify", "delete", "clean", "attr"][int(rng.integers(0, 4))]
        reqid = f"client.1:{v}" if v % 3 else None
        trimmed += log.append(mod.LogEntry(v, op, f"o{int(rng.integers(0, 4))}", reqid))
    got = [[e.to_list() for e in trimmed], [e.to_list() for e in log.entries], log.head,
           log.tail, dict(log.reqids), dict(log.obj_newest), log.find_reqid("client.1:11"),
           log.find_reqid("client.1:2"), log.covers(6), log.covers(8), log.missing_since(7),
           [e.to_list() for e in log.entries_since(9)]]
    assert log.head == 12 and log.tail == 7 and len(log.entries) == 5
    pairs = {mod.PGLog.omap_key(e.version): json.dumps(e.to_list()).encode()
             for e in trimmed + log.entries}
    back = mod.PGLog.load(pairs, log.head, log.tail, limit=5)
    assert [e.to_list() for e in back.entries] == got[1]
    got.append((back.reqids, back.obj_newest))
    log.reset_to(20)
    got.append((log.entries, log.head, log.tail, log.covers(19), dict(log.obj_newest)))
    return got


def _pg_state(mod):
    st = mod.PGState("1.0s2", 1, 0)
    gen = mod._current_generation({0: b"a", 1: b"b", 2: b"c"}, {0: 3, 1: 2, 2: None})
    floor = mod._current_generation({0: b"a", 1: b"b"}, {0: 3, 1: 3}, floor=4)
    assert gen == {0: b"a", 2: b"c"} and floor == {}
    return (st.pgid, st.pool_id, st.ps, st.version, st.log.limit, st.meta_oid(),
            len(st.past_intervals), mod.CLONE_SEP, sorted(mod.MUTATING_OPS), gen, floor)


@pytest.mark.parametrize("case,ref,port", [
    (_pi_queries, ref_pi, port_pi), (_pi_serialization, ref_pi, port_pi),
    (_pg_log, ref_pg_log, port_pg_log), (_pg_state, ref_pg, port_pg),
], ids=["past_intervals_queries", "past_intervals_bytes", "pg_log", "pg_state"])
def test_pg_history_case_matches_reference(case, ref, port):
    assert case(port) == case(ref)
