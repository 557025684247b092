"""LocalCluster — vstart.sh analog: N mons + M OSDs in one process on
localhost sockets, with kill/revive for thrash tests (reference:
src/vstart.sh; qa/standalone/ceph-helpers.sh `run_mon`/`run_osd`/
`kill_daemons`; SURVEY.md §4 ring 2).  The port's counterpart of
ceph_tpu/qa/vstart.py: the cluster takes its ``device`` once (``cuda``
unless ``device="cpu"``) and hands it to every daemon's CephContext (the
mgr's too, with ``with_mgr=True``) and to the initial OSDMap.

    with LocalCluster(n_mons=3, n_osds=6) as c:
        c.create_ec_pool("ecpool", k=4, m=2)      # plugin=torch
        io = c.client().open_ioctx("ecpool")
        io.write_full("x", b"...")
        c.kill_osd(3)
        io.read("x")          # degraded read
        c.revive_osd(3)       # delta recovery kicks in
"""
from __future__ import annotations

import socket
import sys
import time

from ..common.context import CephContext
from ..common.device import resolve_device
from ..crush import CrushWrapper, build_hierarchical_map
from ..mon import MonMap, Monitor
from ..mon.monitor import STATE_PEON
from ..osd.daemon import OSD
from ..osd.osdmap import OSDMap
from ..client.rados import Rados


def _free_addrs(n: int) -> list[tuple[str, int]]:
    socks, addrs = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        addrs.append(("127.0.0.1", s.getsockname()[1]))
    for s in socks:
        s.close()
    return addrs


class LocalCluster:
    def __init__(
        self,
        n_mons: int = 3,
        n_osds: int = 6,
        hosts: int | None = None,
        conf_overrides: dict | None = None,
        with_mgr: bool = False,
        with_mds: bool = False,
        objectstore: str | None = None,
        device=None,
    ):
        """device: where every daemon's GF applies run (``cuda`` unless
        ``"cpu"``; resolved here, so a cluster without a card raises
        before any daemon starts).

        objectstore: None = in-memory stores handed across revives
        (fast, the round-2 behavior).  "kstore"/"bluestore" = PERSISTENT
        mode: each OSD mounts a store under a tmp data dir; kill_osd is
        a crash (no unmount) and revive_osd constructs a FRESH store
        from the same directory — real WAL replay + fsck on mount
        (reference: qa/standalone restarts daemons from disk)."""
        if with_mds:
            raise NotImplementedError(
                "with_mds: CephFS is not ported yet (ROADMAP queue 1 item 8)")
        self.device = resolve_device(device)
        self.with_mgr = with_mgr
        self.mgr = None
        self.n_mons = n_mons
        self.n_osds = n_osds
        self.hosts = hosts or n_osds  # default: one OSD per host bucket
        self.conf_overrides = dict(conf_overrides or {})
        self.objectstore = objectstore
        self.data_dir: str | None = None
        if objectstore:
            import tempfile

            self.data_dir = tempfile.mkdtemp(prefix="ceph_tpu_osd_")
            self.conf_overrides.setdefault("objectstore", objectstore)
            self.conf_overrides.setdefault("osd_data", self.data_dir)
            self.conf_overrides.setdefault("osd_fsck_on_mount", True)
        self.mons: dict[str, Monitor] = {}
        self.osds: dict[int, OSD] = {}
        self.mon_addrs: list = []
        self._clients: list[Rados] = []
        #: (map, {(pool, ps): placement}) — _all_clean's memo
        self._placed: tuple = (None, {})

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LocalCluster":
        addrs = _free_addrs(self.n_mons)
        self.mon_addrs = [list(a) for a in addrs]
        names = [chr(ord("a") + i) for i in range(self.n_mons)]
        monmap = MonMap({names[i]: addrs[i] for i in range(self.n_mons)})
        cmap = build_hierarchical_map(
            self.hosts, -(-self.n_osds // self.hosts)
        )
        initial = OSDMap(CrushWrapper(cmap), max_osd=self.n_osds,
                         device=self.device)
        for nm in names:
            cct = self._cct(f"mon.{nm}")
            mon = Monitor(cct, nm, monmap, initial_osdmap=initial)
            self.mons[nm] = mon
            mon.start()
        # a first leader may be one of a partial quorum that a late mon
        # re-elects: wait until every mon follows one leader whose map
        # has committed, so no election meets the first command
        self._wait("no settled mon quorum", self._quorum_settled)
        if self.with_mgr:
            from ..mgr import MgrDaemon

            # after the mons and before the OSDs, so that the OSDs'
            # contexts read mgr_addr
            self.mgr = MgrDaemon(self._cct("mgr"), self.mon_addrs)
            self.mgr.start()
            # daemons stream MMgrReport here (MgrMap-analog wiring)
            self.conf_overrides["mgr_addr"] = (
                f"{self.mgr.addr[0]}:{self.mgr.addr[1]}"
            )
        for i in range(self.n_osds):
            self._start_osd(i)
        self._wait(f"not all {self.n_osds} OSDs up", self._osds_up)
        return self

    @staticmethod
    def _wait(what: str, cond) -> None:
        deadline = time.monotonic() + 60
        while not cond():
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what} after 60 s")
            time.sleep(0.05)

    def _quorum_settled(self) -> bool:
        leaders = [m for m in self.mons.values() if m.is_leader()]
        if len(leaders) != 1 or leaders[0].osdmon.osdmap is None:
            return False
        return all(m.state == STATE_PEON and m.leader_rank == leaders[0].rank
                   for m in self.mons.values() if m is not leaders[0])

    def _osds_up(self) -> bool:
        maps = [m.osdmon.osdmap for m in self.mons.values() if m.is_leader()]
        return bool(maps) and maps[0] is not None and all(
            maps[0].is_up(i) and i in maps[0].osd_addrs for i in range(self.n_osds))

    def _cct(self, name: str) -> CephContext:
        # overrides go through the constructor: init-time features
        # (admin socket, lockdep) read conf DURING __init__, so setting
        # them afterwards would silently not take
        return CephContext(name, overrides=dict(self.conf_overrides),
                           device=self.device)

    def _start_osd(self, i: int, store=None) -> OSD:
        osd = OSD(self._cct(f"osd.{i}"), i, self.mon_addrs, store=store)
        self.osds[i] = osd
        osd.start()
        return osd

    def _leader(self) -> Monitor:
        """The leader, once one is elected (an election takes a few
        rounds of 0.3 s when the process is busy)."""
        deadline = time.monotonic() + 30
        while True:
            for m in self.mons.values():
                if m.is_leader():
                    return m
            if time.monotonic() > deadline:
                raise RuntimeError("no leader")
            time.sleep(0.05)

    @staticmethod
    def _stop_quietly(label: str, fn) -> None:
        """Best-effort teardown: one daemon dying mid-shutdown must not
        keep the rest of the cluster from stopping — but it must not
        vanish either (a repeatable shutdown crash is a real bug)."""
        try:
            fn()
        except Exception as e:
            print(f"# vstart: {label} shutdown raised: {e!r}",
                  file=sys.stderr)

    def stop(self) -> None:
        for c in self._clients:
            self._stop_quietly("client", c.shutdown)
            # the cluster minted this client's context (_cct), so the
            # cluster retires it — the Rados handle itself never owns
            # its cct (daemons embed Rados handles on shared contexts)
            self._stop_quietly("client cct", c.cct.shutdown)
        for i, osd in sorted(self.osds.items()):
            self._stop_quietly(f"osd.{i}", osd.shutdown)
        if self.mgr is not None:
            self._stop_quietly("mgr", self.mgr.shutdown)
        for mon in self.mons.values():
            self._stop_quietly(f"mon.{mon.name}", mon.shutdown)
        if self.data_dir is not None:
            import shutil

            shutil.rmtree(self.data_dir, ignore_errors=True)

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admin -------------------------------------------------------------
    def client(self, name: str = "client.admin") -> Rados:
        r = Rados(self._cct(name), self.mon_addrs, name=name)
        r.connect()
        self._clients.append(r)
        return r

    def mon_command(self, cmd: dict):
        c = self.client("client.vstart-admin")
        try:
            return c.command(cmd)
        finally:
            self._clients.remove(c)
            c.shutdown()
            c.cct.shutdown()

    def create_ec_pool(
        self, name: str, k: int = 4, m: int = 2, pg_num: int = 8,
        plugin: str = "torch", extra_profile: dict | None = None,
    ) -> None:
        prof = {
            "prefix": "osd erasure-code-profile set",
            "name": f"{name}_profile",
            "profile": {
                "plugin": plugin, "k": str(k), "m": str(m),
                "crush-failure-domain": "osd",
                **(extra_profile or {}),
            },
        }
        rv, res = self.mon_command(prof)
        assert rv == 0, (rv, res)
        rv, res = self.mon_command({
            "prefix": "osd pool create", "name": name, "pg_num": pg_num,
            "pool_type": "erasure", "erasure_code_profile": f"{name}_profile",
        })
        assert rv == 0, (rv, res)
        rv, res = self.mon_command({
            "prefix": "osd pool application enable",
            "pool": name, "app": "rados"})
        assert rv == 0, (rv, res)

    def create_replicated_pool(self, name: str, size: int = 3,
                               pg_num: int = 8,
                               min_size: int | None = None,
                               app: str = "rados") -> None:
        cmd = {
            "prefix": "osd pool create", "name": name, "pg_num": pg_num,
            "size": size,
        }
        if min_size is not None:
            cmd["min_size"] = min_size
        rv, res = self.mon_command(cmd)
        assert rv == 0, (rv, res)
        rv, res = self.mon_command({
            "prefix": "osd pool application enable",
            "pool": name, "app": app})
        assert rv == 0, (rv, res)

    # -- services not ported yet -------------------------------------------
    def start_mds(self) -> None:
        """CephFS's MDS (reference: `ceph fs new` + ceph-mds boot)."""
        raise NotImplementedError(
            "start_mds: CephFS is not ported yet (ROADMAP queue 1 item 8)")

    def fs_client(self, name: str = "client.fs"):
        raise NotImplementedError(
            "fs_client: CephFS is not ported yet (ROADMAP queue 1 item 8)")

    def start_rbd_mirror(self, src_pool: str, dst_pool: str,
                         interval: float = 0.2):
        """An rbd-mirror daemon (reference: the rbd-mirror process per
        pool peer)."""
        raise NotImplementedError(
            "start_rbd_mirror: RBD is not ported yet (ROADMAP queue 1 item 8)")

    def start_rgw(self):
        """The S3 gateway (reference: radosgw)."""
        raise NotImplementedError(
            "start_rgw: RGW is not ported yet (ROADMAP queue 1 item 8)")

    # -- fault injection ---------------------------------------------------
    def kill_osd(self, i: int) -> None:
        """Hard-stop an OSD (the thrasher's kill; reference:
        qa/tasks/thrashosds.py).  In-memory mode stashes the store
        object for revive; persistent mode CRASHES — no unmount, the
        store object is dropped and revive remounts from disk."""
        osd = self.osds.pop(i)
        if self.objectstore:
            osd.shutdown(umount=False)
            return
        self._stores = getattr(self, "_stores", {})
        self._stores[i] = osd.store
        osd.shutdown()

    def revive_osd(self, i: int) -> OSD:
        if self.objectstore:
            # fresh store from the same osd_data subdir: WAL replay +
            # fsck-on-mount happen inside the OSD boot
            return self._start_osd(i)
        store = getattr(self, "_stores", {}).pop(i, None)
        return self._start_osd(i, store=store)

    def mark_osd_down_out(self, i: int) -> None:
        """Push the map change without waiting for failure detection."""
        rv, res = self.mon_command({"prefix": "osd down", "id": i})
        assert rv == 0, (rv, res)
        rv, res = self.mon_command({"prefix": "osd out", "id": i})
        assert rv == 0, (rv, res)

    def mark_osd_in_up(self, i: int) -> None:
        rv, res = self.mon_command({"prefix": "osd in", "id": i})
        assert rv == 0, (rv, res)

    def wait_clean(self, pool: str, timeout: float = 30.0) -> None:
        """Wait until every shard of every PG of a pool reports the
        primary's version (recovery settled)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._all_clean(pool):
                return
            time.sleep(0.3)
        raise TimeoutError(f"pool {pool} not clean after {timeout}s")

    def _all_clean(self, pool_name: str) -> bool:
        leader = self._leader()
        m = leader.osdmon.osdmap
        if m is None:
            return False
        pid = next(
            (i for i, p in m.pools.items() if p.name == pool_name), None
        )
        if pid is None:
            return False
        pool = m.pools[pid]
        # the placements of one map, computed once (the scalar CRUSH
        # descent is the host's own work, and this polls every 0.3 s)
        if self._placed[0] is not m:
            self._placed = (m, {})
        placed = self._placed[1]
        for ps in range(pool.pg_num):
            if (pid, ps) not in placed:
                placed[(pid, ps)] = m.pg_to_up_acting_osds(pid, ps)
            _up, _upp, acting, primary = placed[(pid, ps)]
            if self.osds.get(primary) is None:
                return False
            # every acting shard must agree on ONE version — `peer >=
            # primary` is not enough: a just-revived STALE primary (v1,
            # peers at v2) would read as clean in the window before its
            # pull-forward tick, and reads in that window serve old data
            vers = []
            for shard, o in enumerate(acting):
                if o < 0:
                    continue
                sosd = self.osds.get(o)
                if sosd is None:
                    return False
                spg = sosd.pgs.get(f"{pid}.{ps}")
                vers.append(spg.version if spg is not None else 0)
            if vers and any(v != vers[0] for v in vers):
                return False
            # content completeness: an acting-set permutation can leave a
            # version-current holder without its (new) shard role's
            # objects; versions alone cannot see that
            from ..osd.osdmap import PG_POOL_ERASURE

            is_ec = pool.type == PG_POOL_ERASURE
            posd = self.osds[primary]
            pshard = acting.index(primary) if is_ec else 0
            try:
                pobjs = {
                    obj for obj in posd.store.list_objects(
                        f"{pid}.{ps}s{pshard}")
                    if not obj.startswith("_")
                }
            except Exception:
                pobjs = set()
            for shard, o in enumerate(acting):
                if o < 0 or o == primary:
                    continue
                cid = f"{pid}.{ps}s{shard if is_ec else 0}"
                try:
                    sobjs = set(self.osds[o].store.list_objects(cid))
                except Exception:
                    sobjs = set()
                if pobjs - sobjs:
                    return False
        return True
