"""OSDMonitor — the OSDMap authority (reference: src/mon/OSDMonitor.{h,cc};
SURVEY.md §2.5).

All OSDMap mutations funnel through here on the leader: a pending copy of
the map is mutated, bumped one epoch, and proposed through Paxos as the
store write `osdmap:<epoch>`; on commit every mon reloads and the leader
pushes the new epoch to subscribers.  Key reference behaviors mirrored:

- `osd erasure-code-profile set` validates by INSTANTIATING the codec via
  the ErasureCodePluginRegistry on the monitor context's device — exactly
  the seam where `plugin=torch` gets vetted (reference:
  OSDMonitor::crush_rule_create_erasure path).
- `osd pool create ... erasure <profile>` synthesizes the EC CRUSH rule
  (indep, k+m replicas) from the profile's failure domain.
- MOSDFailure reports are corroborated (`mon_osd_min_down_reporters`
  distinct reporters) before marking down; down OSDs go out after
  `mon_osd_down_out_interval` unless `noout` is set (reference: §5.3).
"""
from __future__ import annotations

import json
import time

from ..crush import add_simple_rule
from ..ec.interface import InvalidProfile
from ..ec.registry import ErasureCodePluginRegistry
from ..osd.osdmap import OSDMap, PG_POOL_ERASURE, PG_POOL_REPLICATED

_K_LAST_OSDMAP = "osdmap:last"


def _map_key(epoch: int) -> str:
    return f"osdmap:{epoch:010d}"


class OSDMonitor:
    def __init__(self, mon, initial_map: OSDMap | None = None):
        self.mon = mon
        self.osdmap: OSDMap | None = None
        # failure corroboration state (leader-local, reference:
        # OSDMonitor::failure_info)
        self._failure_reporters: dict[int, set[str]] = {}
        self._down_stamp: dict[int, float] = {}
        self.refresh()
        if self.osdmap is None and initial_map is not None and mon.rank == 0:
            self._initial = initial_map
        else:
            self._initial = None

    # -- store sync --------------------------------------------------------
    def refresh(self) -> None:
        """Reload the latest committed map (reference:
        OSDMonitor::update_from_paxos)."""
        raw = self.mon.store.get(_K_LAST_OSDMAP)
        if raw is None:
            return
        epoch = int(raw)
        map_raw = self.mon.store.get(_map_key(epoch))
        if map_raw is not None:
            self.osdmap = OSDMap.from_json(json.loads(map_raw.decode()),
                                           device=self.mon.cct.device)

    def on_elected_leader(self) -> None:
        """First leader seeds the initial map (vstart hands it in)."""
        if self.osdmap is None and self._initial is not None:
            self._propose_map(self._initial)

    def get_map_json(self, epoch: int) -> dict | None:
        raw = self.mon.store.get(_map_key(epoch))
        return json.loads(raw.decode()) if raw is not None else None

    @property
    def epoch(self) -> int:
        return self.osdmap.epoch if self.osdmap is not None else 0

    # -- mutation plumbing -------------------------------------------------
    def _pending(self) -> OSDMap:
        if self.osdmap is None:
            raise RuntimeError("no osdmap committed yet")
        return OSDMap.from_json(self.osdmap.to_json(),
                                device=self.mon.cct.device)

    def _propose_map(self, new_map: OSDMap) -> bool:
        new_map.epoch = max(new_map.epoch, self.epoch + 1)
        blob = json.dumps(new_map.to_json()).encode()
        ops = [
            (1, _map_key(new_map.epoch), blob),
            (1, _K_LAST_OSDMAP, str(new_map.epoch).encode()),
        ]
        ok = self.mon.paxos.propose(ops)
        if ok:
            self.mon.publish_osdmap()
        return ok

    # -- boot / failure (reference: §3.4, §5.3) ---------------------------
    def handle_boot(self, osd: int, addr: tuple[str, int]) -> bool:
        m = self._pending()
        if not (0 <= osd < m.max_osd):
            return False
        m.mark_up(osd)
        m.osd_addrs[osd] = addr
        self._failure_reporters.pop(osd, None)
        self._down_stamp.pop(osd, None)
        return self._propose_map(m)

    def handle_failure(self, target: int, reporter: str) -> bool:
        """Corroborated failure reports → down (reference:
        OSDMonitor::prepare_failure)."""
        if self.osdmap is None or not self.osdmap.is_up(target):
            return False
        if "nodown" in self.osdmap.flags:
            return False
        reporters = self._failure_reporters.setdefault(target, set())
        reporters.add(reporter)
        needed = self.mon.cct.conf.get("mon_osd_min_down_reporters")
        if len(reporters) < needed:
            return False
        m = self._pending()
        m.mark_down(target)
        del self._failure_reporters[target]
        self._down_stamp[target] = time.monotonic()
        return self._propose_map(m)

    def handle_alive(self, target: int, reporter: str) -> None:
        reporters = self._failure_reporters.get(target)
        if reporters:
            reporters.discard(reporter)

    def tick(self) -> None:
        """down → out after the grace (reference: mon_osd_down_out_interval
        in OSDMonitor::tick)."""
        if self.osdmap is None or not self.mon.is_leader():
            return
        if "noout" in self.osdmap.flags:
            return
        grace = self.mon.cct.conf.get("mon_osd_down_out_interval")
        now = time.monotonic()
        to_out = [
            o for o, t in self._down_stamp.items()
            if now - t >= grace and self.osdmap.osd_weight[o] != 0
            and not self.osdmap.is_up(o)
        ]
        if not to_out:
            return
        m = self._pending()
        for o in to_out:
            m.mark_out(o)
            del self._down_stamp[o]
        self._propose_map(m)

    # -- commands ----------------------------------------------------------
    def handle_command(self, cmd: dict) -> tuple[int, object]:
        """Returns (retval, result) — retval 0 on success (reference:
        OSDMonitor::prepare_command)."""
        prefix = cmd.get("prefix", "")
        if prefix == "osd dump":
            return 0, self.osdmap.to_json() if self.osdmap else {}
        if prefix == "osd getmap":
            # historical epoch fetch (reference: mon serving old maps for
            # OSD pg-history reconstruction / PastIntervals rebuild)
            try:
                e = int(cmd.get("epoch", 0))
            except (TypeError, ValueError):
                return -22, "bad epoch"
            if e <= 0:  # no/zero epoch = the current map, like `osd dump`
                e = self.osdmap.epoch if self.osdmap else 0
            j = self.get_map_json(e)
            return (0, j) if j is not None else (-2, f"no map epoch {e}")
        if prefix == "osd getmaps":
            # batched range fetch for interval-history rebuilds: 64
            # epochs per call keeps one recovery pass at ~8 round trips
            # instead of 512 (review r4); trimmed epochs are omitted
            try:
                first = int(cmd.get("first", 0))
                last = int(cmd.get("last", 0))
            except (TypeError, ValueError):
                return -22, "bad epoch range"
            if first < 1 or last < first:
                return -22, f"bad epoch range [{first},{last}]"
            last = min(last, first + 63)
            out = {}
            for e in range(first, last + 1):
                j = self.get_map_json(e)
                if j is not None:
                    out[str(e)] = j
            return 0, {"maps": out, "last": last}
        if prefix == "osd stat":
            return 0, self._stat()
        if prefix == "mgr digest":
            # reference: MMonMgrReport -> MgrStatMonitor; the mgr streams
            # its PGMap digest here so df/pg-dump answer from the mon
            d = cmd.get("digest")
            if not isinstance(d, dict):
                return -22, "digest must be a dict"
            self.mgr_digest = (time.monotonic(), d)
            return 0, "ok"
        if prefix in ("df", "osd df", "pg dump"):
            return self._cmd_from_digest(prefix)
        if prefix == "perf history":
            return self._cmd_perf_history(cmd)
        if prefix == "progress":
            return self._cmd_progress()
        if prefix == "balancer status":
            return self._cmd_balancer_status()
        if prefix == "placement diff":
            return self._cmd_placement_diff()
        if prefix == "osd erasure-code-profile set":
            return self._cmd_profile_set(cmd)
        if prefix == "osd erasure-code-profile get":
            name = cmd.get("name", "")
            prof = (self.osdmap.ec_profiles if self.osdmap else {}).get(name)
            return (0, prof) if prof is not None else (-2, f"no profile {name!r}")
        if prefix == "osd erasure-code-profile ls":
            return 0, sorted(self.osdmap.ec_profiles) if self.osdmap else []
        if prefix == "osd pool create":
            return self._cmd_pool_create(cmd)
        if prefix == "osd pool ls":
            if not self.osdmap:
                return 0, []
            if cmd.get("detail"):
                return 0, [vars(p) for p in self.osdmap.pools.values()]
            return 0, [p.name for p in self.osdmap.pools.values()]
        if prefix in ("osd down", "osd out", "osd in"):
            return self._cmd_osd_state(prefix.split()[1], cmd)
        if prefix == "osd crush add-bucket":
            m = self._pending()
            try:
                m.crush.add_bucket(cmd.get("name", ""),
                                   cmd.get("type", ""))
            except (ValueError, KeyError) as e:
                return -22, str(e)
            return (0, f"added bucket {cmd.get('name')!r}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix == "osd crush move":
            m = self._pending()
            try:
                m.crush.move_item(cmd.get("name", ""),
                                  cmd.get("dest", ""))
            except (ValueError, KeyError) as e:
                return -22, str(e)
            return (0, f"moved {cmd.get('name')!r} under "
                       f"{cmd.get('dest')!r}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix == "osd crush rm":
            m = self._pending()
            try:
                m.crush.remove_item(cmd.get("name", ""))
            except (ValueError, KeyError) as e:
                return -22, str(e)
            return (0, f"removed {cmd.get('name')!r}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix == "osd crush reweight":
            # reference: OSDMonitor prepare_command OSD_CRUSH_REWEIGHT —
            # distinct from `osd reweight` (the probabilistic in/out
            # thinning): this changes the CRUSH weight, i.e. placement
            try:
                w = float(cmd.get("weight"))
            except (TypeError, ValueError):
                return -22, "numeric weight required"
            m = self._pending()
            try:
                m.crush.reweight_item(cmd.get("name", ""), w)
            except (KeyError, ValueError) as e:
                return -22, str(e)
            return (0, f"reweighted {cmd.get('name')} to {w}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix in ("osd reweight", "osd primary-affinity"):
            # reference: OSDMonitor prepare_command OSD_REWEIGHT /
            # OSD_PRIMARY_AFFINITY — 0.0..1.0 stored as 16.16 fixed
            try:
                osd = int(cmd.get("id"))
                w = float(cmd.get("weight"))
            except (TypeError, ValueError):
                return -22, "need id and weight"
            if not (0.0 <= w <= 1.0):
                return -22, f"weight {w} out of [0, 1]"
            if self.osdmap is None or not (0 <= osd < self.osdmap.max_osd):
                return -22, f"no osd.{osd}"
            m = self._pending()
            fixed = int(round(w * 0x10000))
            if prefix == "osd reweight":
                m.osd_weight[osd] = fixed
            else:
                m.osd_primary_affinity[osd] = fixed
            what = prefix.split()[1]
            return (0, f"{what} osd.{osd} to {w}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix in ("osd set", "osd unset"):
            flag = cmd.get("key", "")
            if flag not in ("noout", "nodown", "noup"):
                return -22, f"unknown flag {flag!r}"
            m = self._pending()
            (m.flags.add if prefix == "osd set" else m.flags.discard)(flag)
            return (0, f"{flag} {'set' if prefix == 'osd set' else 'unset'}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix == "osd pool set":
            return self._cmd_pool_set(cmd)
        if prefix == "osd pool set-quota":
            return self._cmd_pool_quota(cmd)
        if prefix == "osd pool get-quota":
            name = cmd.get("name", "")
            pool = next((p for p in self.osdmap.pools.values()
                         if p.name == name), None) if self.osdmap else None
            if pool is None:
                return -2, f"no pool {name!r}"
            return 0, {"quota_max_bytes": pool.quota_max_bytes,
                       "quota_max_objects": pool.quota_max_objects,
                       "full": "full_quota" in pool.flags}
        if prefix == "osd pool quota-flag":
            # internal: the mgr's quota loop flips FULL_QUOTA when stats
            # cross/clear the quota (reference: the mon's own stats-driven
            # pool FULL flag; our stats live in the mgr)
            name = cmd.get("name", "")
            m = self._pending()
            pool = next((p for p in m.pools.values() if p.name == name),
                        None)
            if pool is None:
                return -2, f"no pool {name!r}"
            want = bool(int(cmd.get("full", 0)))
            have = "full_quota" in pool.flags
            if want == have:
                return 0, "unchanged"
            if want:
                pool.flags.append("full_quota")
            else:
                pool.flags.remove("full_quota")
            return (0, f"full_quota={'set' if want else 'cleared'}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix == "osd pool rm":
            return self._cmd_pool_rm(cmd)
        if prefix == "osd ok-to-stop":
            return self._cmd_ok_to_stop(cmd)
        if prefix == "osd safe-to-destroy":
            return self._cmd_safe_to_destroy(cmd)
        if prefix == "osd pool application enable":
            return self._cmd_pool_application(cmd, enable=True)
        if prefix == "osd pool application disable":
            return self._cmd_pool_application(cmd, enable=False)
        if prefix == "osd pool application get":
            m = self.osdmap
            pool = next((p for p in m.pools.values()
                         if p.name == cmd.get("pool")), None)
            if pool is None:
                return -2, f"no pool {cmd.get('pool')!r}"
            return 0, pool.application
        if prefix == "osd pool rename":
            src_n, dst_n = cmd.get("srcpool", ""), cmd.get("destpool", "")
            if not src_n or not dst_n:
                return -22, "srcpool and destpool required"
            m = self._pending()
            if any(p.name == dst_n for p in m.pools.values()):
                return -17, f"pool {dst_n!r} already exists"
            pool = next((p for p in m.pools.values() if p.name == src_n),
                        None)
            if pool is None:
                return -2, f"no pool {src_n!r}"
            pool.name = dst_n
            return (0, f"pool {src_n!r} renamed to {dst_n!r}") \
                if self._propose_map(m) else (-110, "proposal timed out")
        if prefix in ("osd pool mksnap", "osd pool rmsnap"):
            return self._cmd_pool_snap(prefix.endswith("mksnap"), cmd)
        if prefix == "osd pg-upmap-items":
            return self._cmd_upmap_items(cmd)
        if prefix.startswith("osd tier "):
            return self._cmd_tier(prefix[len("osd tier "):], cmd)
        if prefix == "osd tree":
            return 0, self._cmd_tree()
        if prefix == "auth get-ticket":
            return self._cmd_auth_ticket(cmd)
        if prefix == "auth rotate":
            return self._cmd_auth_rotate(cmd)
        if prefix == "auth gens":
            return 0, dict(self.osdmap.auth_gens) if self.osdmap else {}
        if prefix == "auth get-s3-key":
            return self._cmd_auth_s3_key(cmd)
        return -22, f"unknown command {prefix!r}"

    # -- cephx KeyServer role (reference: src/auth/cephx CephxKeyServer;
    # the mon mints service tickets, and rotation is an OSDMap change so
    # it reaches every daemon through paxos + subscriptions) -------------
    def _cluster_secret(self) -> bytes | None:
        """Same parsing + length rules as the messengers
        (CephxAuthenticator) — the mon must never mint tickets under a
        secret the acceptors refuse to load."""
        from ..auth import AuthError, CephxAuthenticator

        s = self.mon.cct.conf.get("auth_shared_secret")
        if not s:
            return None
        try:
            return CephxAuthenticator(s).secret
        except AuthError:
            return None

    def _cmd_auth_ticket(self, cmd: dict) -> tuple[int, object]:
        """`auth get-ticket service=<svc> [entity=<name>] [ttl=<secs>]` —
        mints a sealed service ticket + session key.  Reaches the client
        over its (authenticated, frame-signed) mon session; a cluster
        with auth off can still mint, which tests use to pre-provision."""
        from ..auth import mint_ticket

        secret = self._cluster_secret()
        if secret is None:
            return -1, "no cluster secret configured (auth_shared_secret)"
        service = cmd.get("service", "")
        if not service or not service.isidentifier():
            return -22, f"bad service {service!r}"
        entity = cmd.get("entity", "client.admin")
        ttl = float(cmd.get("ttl")
                    or self.mon.cct.conf.get("auth_service_ticket_ttl"))
        gen = (self.osdmap.auth_gens.get(service, 1)
               if self.osdmap is not None else 1)
        blob, session_key = mint_ticket(secret, entity, service, gen, ttl)
        return 0, {"service": service, "entity": entity, "gen": gen,
                   "ticket": blob, "session_key": session_key}

    def _cmd_auth_s3_key(self, cmd: dict) -> tuple[int, object]:
        """`auth get-s3-key entity=<name>` — S3 credentials DERIVED from
        the cephx cluster secret at the current "rgw" generation, so
        `auth rotate service=rgw` invalidates outstanding keys (the
        RGWUserInfo-credential role without a user database)."""
        from ..auth import derive_s3_secret

        secret = self._cluster_secret()
        if secret is None:
            return -1, "no cluster secret configured (auth_shared_secret)"
        entity = cmd.get("entity", "client.admin")
        if not entity or any(c in entity for c in " /,"):
            return -22, f"bad entity {entity!r}"
        gen = (self.osdmap.auth_gens.get("rgw", 1)
               if self.osdmap is not None else 1)
        return 0, {"access_key": entity, "gen": gen,
                   "secret_key": derive_s3_secret(secret, entity, gen)}

    def _cmd_auth_rotate(self, cmd: dict) -> tuple[int, object]:
        """`auth rotate service=<svc>` — bump the service's key
        generation in the OSDMap.  Daemons accept {gen, gen-1}
        (validate_ticket's grace window), so one rotation starts the
        cutover and a second one cuts stale tickets off entirely."""
        service = cmd.get("service", "")
        if not service or not service.isidentifier():
            return -22, f"bad service {service!r}"
        m = self._pending()
        new_gen = m.auth_gens.get(service, 1) + 1
        m.auth_gens[service] = new_gen
        if not self._propose_map(m):
            return -110, "proposal timed out"
        return 0, {"service": service, "gen": new_gen}

    def _cmd_pool_quota(self, cmd: dict) -> tuple[int, object]:
        """`osd pool set-quota <pool> max_bytes|max_objects <val>`
        (reference: OSDMonitor prepare_command OSD_POOL_SET_QUOTA);
        0 clears."""
        name = cmd.get("name", "")
        fieldn = cmd.get("field", "")
        if fieldn not in ("max_bytes", "max_objects"):
            return -22, f"field {fieldn!r}: want max_bytes|max_objects"
        try:
            value = int(cmd.get("value"))
        except (TypeError, ValueError):
            return -22, "integer value required"
        if value < 0:
            return -22, f"quota {value} must be >= 0"
        m = self._pending()
        pool = next((p for p in m.pools.values() if p.name == name), None)
        if pool is None:
            return -2, f"no pool {name!r}"
        setattr(pool, f"quota_{fieldn}", value)
        if value == 0 and not (pool.quota_max_bytes
                               or pool.quota_max_objects):
            # clearing the last quota lifts a standing full flag
            if "full_quota" in pool.flags:
                pool.flags.remove("full_quota")
        return (0, f"set quota_{fieldn} = {value} on {name!r}") \
            if self._propose_map(m) else (-110, "proposal timed out")

    def _cmd_pool_set(self, cmd: dict) -> tuple[int, object]:
        """`osd pool set <pool> <key> <value>` — pg_num/pgp_num/size
        (reference: OSDMonitor::prepare_command_pool_set).  pg_num may
        only grow (splits; merges are out of scope), and pgp_num follows
        pg_num so placement tracks the split immediately."""
        name = cmd.get("name", "")
        key = cmd.get("key", "")
        try:
            value = int(cmd.get("value"))
        except (TypeError, ValueError):
            return -22, f"pool set {key}: integer value required"
        m = self._pending()
        pool = next((p for p in m.pools.values() if p.name == name), None)
        if pool is None:
            return -2, f"no pool {name!r}"
        if key == "pg_num":
            if value < pool.pg_num:
                return -22, (
                    f"pg_num {value} < current {pool.pg_num}: "
                    "merges not supported"
                )
            if value == pool.pg_num:
                return 0, f"pg_num already {value}"
            per_osd = self.mon.cct.conf.get("mon_max_pg_per_osd")
            n_osds = max(1, sum(1 for o in range(m.max_osd) if m.is_up(o)))
            if value * pool.size > per_osd * n_osds:
                return -34, (  # ERANGE, as the reference returns
                    f"pg_num {value} would exceed "
                    f"mon_max_pg_per_osd {per_osd}"
                )
            pool.pg_num = value
            pool.pgp_num = value
        elif key == "pgp_num":
            if not (1 <= value <= pool.pg_num):
                return -22, (
                    f"pgp_num {value} must be in [1, pg_num={pool.pg_num}]"
                )
            pool.pgp_num = value
        elif key == "size":
            if pool.type == PG_POOL_ERASURE:
                # EC width is k+m from the profile, not a free knob
                return -95, "cannot change size of an erasure-coded pool"
            if not (1 <= value <= 10):
                return -22, f"size {value} out of range"
            pool.size = value
            # keep the derived write quorum consistent (the same rule
            # PGPool.__post_init__ applies at creation)
            pool.min_size = value - value // 2
        elif key == "target_max_objects":
            # cache-tier agent threshold (reference: pg_pool_t::
            # target_max_objects driving agent_choose_mode)
            if value < 0:
                return -22, "target_max_objects must be >= 0"
            pool.target_max_objects = value
        else:
            return -22, f"unknown pool key {key!r}"
        return (0, f"set pool {name} {key} to {value}") \
            if self._propose_map(m) else (-110, "proposal timed out")

    def _cmd_pool_snap(self, create: bool, cmd: dict) -> tuple[int, object]:
        """`osd pool mksnap/rmsnap <pool> <snapname>` (reference:
        OSDMonitor's pool-snap commands updating pg_pool_t::snaps)."""
        name = cmd.get("name", "")
        snapname = cmd.get("snapname", "")
        if not snapname:
            return -22, "snap name required"
        m = self._pending()
        pool = next((p for p in m.pools.values() if p.name == name), None)
        if pool is None:
            return -2, f"no pool {name!r}"
        if create:
            if snapname in pool.snaps.values():
                return -17, f"snap {snapname!r} exists"
            pool.snap_seq += 1
            pool.snaps[pool.snap_seq] = snapname
            result = {"snapid": pool.snap_seq}
        else:
            sid = next(
                (i for i, n in pool.snaps.items() if n == snapname), None
            )
            if sid is None:
                return -2, f"no snap {snapname!r}"
            del pool.snaps[sid]
            result = {"removed": sid}
        return (0, result) if self._propose_map(m) else \
            (-110, "proposal timed out")

    def _cmd_tier(self, sub: str, cmd: dict) -> tuple[int, object]:
        """`osd tier add/remove/cache-mode/set-overlay/remove-overlay`
        (reference: OSDMonitor::prepare_command's "osd tier *" family
        mutating pg_pool_t tier fields).  `pool` names the BASE pool and
        `tierpool` the cache for add/remove/set-overlay; cache-mode takes
        the cache pool in `pool`."""
        m = self._pending()

        def by_name(n):
            return next((p for p in m.pools.values() if p.name == n), None)

        pool = by_name(cmd.get("pool", ""))
        if pool is None:
            return -2, f"no pool {cmd.get('pool')!r}"
        if sub in ("add", "remove", "set-overlay"):
            tierpool = by_name(cmd.get("tierpool", ""))
            if tierpool is None:
                return -2, f"no tier pool {cmd.get('tierpool')!r}"
        if sub == "add":
            if tierpool.pool_id == pool.pool_id:
                return -22, "pool cannot tier itself"
            if tierpool.tier_of >= 0 and tierpool.tier_of != pool.pool_id:
                return -16, f"pool {tierpool.name!r} is already a tier"
            if tierpool.tiers or pool.tier_of >= 0:
                return -22, "multi-level tiering not supported"
            if tierpool.type == PG_POOL_ERASURE:
                # the cache must serve arbitrary overwrites cheaply
                return -95, "an erasure-coded pool cannot be a cache tier"
            tierpool.tier_of = pool.pool_id
            if tierpool.pool_id not in pool.tiers:
                pool.tiers.append(tierpool.pool_id)
            result = f"pool {tierpool.name!r} is now a tier of {pool.name!r}"
        elif sub == "remove":
            if tierpool.tier_of != pool.pool_id:
                return -2, f"pool {tierpool.name!r} is not a tier of {pool.name!r}"
            if pool.read_tier == tierpool.pool_id or \
                    pool.write_tier == tierpool.pool_id:
                return -16, "remove the overlay first"
            tierpool.tier_of = -1
            tierpool.cache_mode = "none"
            pool.tiers = [t for t in pool.tiers if t != tierpool.pool_id]
            result = f"pool {tierpool.name!r} removed as tier of {pool.name!r}"
        elif sub == "cache-mode":
            mode = cmd.get("mode", "")
            if mode not in ("none", "writeback", "readproxy"):
                return -22, f"unknown cache mode {mode!r}"
            if pool.tier_of < 0:
                return -22, f"pool {pool.name!r} is not a tier"
            if mode == "none":
                # with the overlay still routing base I/O here, mode none
                # would bypass promotion and make every non-cached base
                # object unreadable (the reference refuses this too)
                basep = m.pools.get(pool.tier_of)
                if basep is not None and pool.pool_id in (
                    basep.read_tier, basep.write_tier
                ):
                    return -16, (
                        f"pool {pool.name!r} is the overlay for "
                        f"{basep.name!r}; remove-overlay first"
                    )
            pool.cache_mode = mode
            result = f"set cache-mode of {pool.name!r} to {mode}"
        elif sub == "set-overlay":
            if tierpool.tier_of != pool.pool_id:
                return -22, f"pool {tierpool.name!r} is not a tier of {pool.name!r}"
            if tierpool.cache_mode == "none":
                # mirror of the cache-mode-none guard above (advisor r4):
                # an overlay onto a mode-none tier redirects all base I/O
                # to a cache whose OSD front-end is disabled — reads of
                # non-cached objects 404 and writes land tier-less
                return -16, (
                    f"pool {tierpool.name!r} has cache-mode none; set "
                    f"cache-mode first"
                )
            pool.read_tier = pool.write_tier = tierpool.pool_id
            result = f"overlay for {pool.name!r} is now {tierpool.name!r}"
        elif sub == "remove-overlay":
            pool.read_tier = pool.write_tier = -1
            result = f"overlay for {pool.name!r} removed"
        else:
            return -22, f"unknown tier command {sub!r}"
        return (0, result) if self._propose_map(m) else \
            (-110, "proposal timed out")

    def _cmd_tree(self) -> list[dict]:
        """reference: `ceph osd tree` (OSDMonitor dumping the CRUSH
        hierarchy annotated with up/in state)."""
        m = self.osdmap
        if m is None:
            return []
        w = m.crush
        rows: list[dict] = []

        def walk(item: int, depth: int) -> None:
            if item >= 0:
                rows.append({
                    "id": item,
                    "name": f"osd.{item}",
                    "type": "osd",
                    "depth": depth,
                    "reweight": m.osd_weight[item] / 0x10000
                    if item < m.max_osd else 0.0,
                    "status": "up" if m.is_up(item) else "down",
                })
                return
            b = w.map.buckets[item]
            rows.append({
                "id": item,
                "name": w.name_of(item),
                "type": w.type_name(b.type),
                "depth": depth,
                "weight": b.weight / 0x10000,
            })
            for child in b.items:
                walk(child, depth + 1)

        roots = set(w.map.buckets) - {
            c for b in w.map.buckets.values() for c in b.items if c < 0
        }
        for root in sorted(roots, reverse=True):
            walk(root, 0)
        return rows

    def _cmd_perf_history(self, cmd: dict) -> tuple[int, object]:
        """`ceph perf history [name] [daemon]` — recent samples of the
        digest's perf series (cephmeter; reference: the reads a
        closed-loop controller does against its own series, served
        mon-side from the MMonMgrReport digest like df/pg dump)."""
        ts_digest = getattr(self, "mgr_digest", None)
        if ts_digest is None:
            return -2, "no mgr digest yet (is the mgr running?)"
        ts, digest = ts_digest
        hist = digest.get("perf_history")
        if not isinstance(hist, dict) or not hist.get("daemons"):
            return -2, "digest carries no perf history yet"
        name = cmd.get("name")
        daemon = cmd.get("daemon")
        daemons = {}
        for d, series in (hist.get("daemons") or {}).items():
            if daemon is not None and d != daemon:
                continue
            keep = {n: s for n, s in series.items()
                    if name is None or n == name}
            if keep:
                daemons[d] = keep
        if (name is not None or daemon is not None) and not daemons:
            return -2, (f"no history for name={name!r} daemon={daemon!r}; "
                        f"names: {hist.get('names')}")
        return 0, {
            "digest_age_seconds": round(time.monotonic() - ts, 1),
            "names": hist.get("names"),
            "samples_per_series": hist.get("samples_per_series"),
            "daemons": daemons,
        }

    def _cmd_progress(self) -> tuple[int, object]:
        """`ceph progress` (cephheal; reference: the mgr progress
        module's `ceph progress` output) — per-PG recovery/backfill
        events with completion fraction, drain rate, and ETA, served
        mon-side from the digest like perf history."""
        ts_digest = getattr(self, "mgr_digest", None)
        if ts_digest is None:
            return -2, "no mgr digest yet (is the mgr running?)"
        ts, digest = ts_digest
        prog = digest.get("progress")
        if not isinstance(prog, dict):
            return -2, ("digest carries no progress data yet (is the "
                        "progress module hosted?)")
        return 0, {
            "digest_age_seconds": round(time.monotonic() - ts, 1),
            "events": prog.get("events") or [],
            "completed": prog.get("completed") or [],
            "stalled": prog.get("stalled") or [],
            "failing": prog.get("failing") or {},
        }

    def _cmd_balancer_status(self) -> tuple[int, object]:
        """`ceph balancer status` (cephplace; reference: the balancer
        module's `balancer status` output) — passes, move outcomes,
        pre/post skew scores, last error — served mon-side from the
        digest like perf history."""
        ts_digest = getattr(self, "mgr_digest", None)
        if ts_digest is None:
            return -2, "no mgr digest yet (is the mgr running?)"
        ts, digest = ts_digest
        bal = digest.get("balancer")
        if not isinstance(bal, dict):
            return -2, ("digest carries no balancer data yet (is the "
                        "balancer module hosted?)")
        return 0, {
            "digest_age_seconds": round(time.monotonic() - ts, 1),
            **bal,
        }

    def _cmd_placement_diff(self) -> tuple[int, object]:
        """`ceph placement diff` (cephplace) — the latest osdmap-epoch
        remap forecast (PGs/shards remapped, predicted bytes-to-move,
        misplaced fraction) plus the current skew snapshot, served
        mon-side from the digest."""
        ts_digest = getattr(self, "mgr_digest", None)
        if ts_digest is None:
            return -2, "no mgr digest yet (is the mgr running?)"
        ts, digest = ts_digest
        pl = digest.get("placement")
        if not isinstance(pl, dict):
            return -2, ("digest carries no placement data yet (is the "
                        "placement module hosted?)")
        return 0, {
            "digest_age_seconds": round(time.monotonic() - ts, 1),
            "cluster": pl.get("cluster"),
            "pools": pl.get("pools") or [],
            "imbalanced": pl.get("imbalanced") or [],
            "diff": pl.get("diff"),
        }

    def _cmd_from_digest(self, prefix: str) -> tuple[int, object]:
        """Serve `df`/`osd df`/`pg dump` from the mgr's streamed digest
        (reference: MgrStatMonitor::preprocess_statfs / PGMap dumps).
        pg-dump placement columns come live from the mon's own map —
        only state/version need the digest."""
        ts_digest = getattr(self, "mgr_digest", None)
        if ts_digest is None:
            # NOT -11: MonClient treats EAGAIN as "leader still syncing"
            # and retry-loops into a misleading timeout
            return -2, "no mgr digest yet (is the mgr running?)"
        ts, digest = ts_digest
        age = time.monotonic() - ts
        if prefix == "df":
            out = dict(digest.get("df") or {})
            out["digest_age_seconds"] = round(age, 1)
            return 0, out
        if prefix == "osd df":
            out = dict(digest.get("osd_df") or {})
            out["digest_age_seconds"] = round(age, 1)
            return 0, out
        m = self.osdmap
        pg_info = digest.get("pg_info") or {}
        rows = []
        for pid, pool in sorted(m.pools.items()):
            for ps in range(pool.pg_num):
                up, upp, acting, prim = m.pg_to_up_acting_osds(pid, ps)
                pgid = f"{pid}.{ps}"
                info = pg_info.get(pgid) or {}
                rows.append({
                    "pgid": pgid,
                    "state": info.get("state", "unknown"),
                    "version": info.get("version", 0),
                    "up": up, "up_primary": upp,
                    "acting": acting, "acting_primary": prim,
                })
        return 0, {"pg_stats": rows, "digest_age_seconds": round(age, 1)}

    def _stat(self) -> dict:
        m = self.osdmap
        if m is None:
            return {"num_osds": 0}
        up = sum(1 for o in range(m.max_osd) if m.is_up(o))
        inn = sum(1 for o in range(m.max_osd) if m.osd_weight[o] != 0)
        return {
            "epoch": m.epoch, "num_osds": m.max_osd, "num_up_osds": up,
            "num_in_osds": inn, "flags": sorted(m.flags),
        }

    def _cmd_profile_set(self, cmd: dict) -> tuple[int, object]:
        name = cmd.get("name")
        if not name:
            return -22, "profile name required"
        profile = dict(cmd.get("profile", {}))
        profile.setdefault("plugin", "torch")
        # validation = instantiation through the registry, the reference's
        # exact mechanism (OSDMonitor validating plugin=torch end to end),
        # on the device the cluster runs on
        try:
            codec = ErasureCodePluginRegistry.instance().factory(
                profile, device=self.mon.cct.device)
        except InvalidProfile as e:
            return -22, str(e)
        m = self._pending()
        if name in m.ec_profiles and m.ec_profiles[name] != profile:
            in_use = any(p.ec_profile == name for p in m.pools.values())
            if in_use and not cmd.get("force"):
                return -1, f"profile {name!r} is in use; --force to override"
        m.ec_profiles[name] = profile
        if not self._propose_map(m):
            return -110, "proposal timed out"
        return 0, {
            "name": name, "profile": profile,
            "k": codec.get_data_chunk_count(),
            "m": codec.get_chunk_count() - codec.get_data_chunk_count(),
        }

    def _cmd_ok_to_stop(self, cmd: dict) -> tuple[int, object]:
        """Would stopping these OSDs leave every PG at or above
        min_size?  Pure map arithmetic (reference: OSDMonitor
        check_pg_num / ok-to-stop returning EBUSY when data
        availability would be lost)."""
        try:
            ids = {int(i) for i in cmd.get("ids", [])}
        except (TypeError, ValueError):
            return -22, "ids must be osd numbers"
        if not ids:
            return -22, "no osd ids given"
        m = self.osdmap
        unsafe = []
        for pid, pool in m.pools.items():
            for ps in range(pool.pg_num):
                _up, _upp, acting, _p = m.pg_to_up_acting_osds(pid, ps)
                left = [o for o in acting if o not in ids and o >= 0]
                if acting and len(left) < pool.min_size:
                    unsafe.append(f"{pid}.{ps}")
        if unsafe:
            return -16, {
                "ok_to_stop": False,
                "unsafe_pgs": unsafe[:32],
                "num_unsafe": len(unsafe),
            }
        return 0, {"ok_to_stop": True, "osds": sorted(ids)}

    def _cmd_safe_to_destroy(self, cmd: dict) -> tuple[int, object]:
        """Destroying is safe once the OSD hosts no PGs: it must be out
        of every acting set AND its last mgr-reported pg count must be
        zero (reference: OSDMonitor osd safe-to-destroy)."""
        try:
            osd = int(cmd.get("id", -1))
        except (TypeError, ValueError):
            return -22, "bad osd id"
        m = self.osdmap
        if not (0 <= osd < m.max_osd) or not m.exists(osd):
            return -2, f"osd.{osd} does not exist"
        mapped = []
        for pid, pool in m.pools.items():
            for ps in range(pool.pg_num):
                _up, _upp, acting, _p = m.pg_to_up_acting_osds(pid, ps)
                if osd in acting:
                    mapped.append(f"{pid}.{ps}")
        ts_digest = getattr(self, "mgr_digest", None)
        reported = None
        if ts_digest is not None:
            for row in (ts_digest[1].get("osd_df") or {}).get("nodes", []):
                if row.get("id") == osd:
                    reported = row.get("pgs")
        if mapped:
            return -16, {"safe": False, "mapped_pgs": len(mapped)}
        if reported is None:
            # no mgr stats: refuse rather than approve blind — the OSD
            # may still hold data being drained (reference returns
            # EAGAIN "no osd_stat"; -11 would make MonClient retry-loop)
            return -16, {"safe": False,
                         "reason": "no mgr pg report for this osd "
                                   "(is the mgr running?)"}
        if reported != 0:
            return -16, {"safe": False, "reported_pgs": reported}
        return 0, {"safe": True, "osd": osd}

    def _cmd_pool_application(self, cmd: dict,
                              enable: bool) -> tuple[int, object]:
        """reference: OSDMonitor prepare_command_pool_application —
        tag a pool with the client application using it (rbd/rgw/
        cephfs/rados); untagged pools raise POOL_APP_NOT_ENABLED."""
        app = cmd.get("app", "")
        if not app:
            return -22, "application name required"
        m = self._pending()
        pool = next((p for p in m.pools.values()
                     if p.name == cmd.get("pool")), None)
        if pool is None:
            return -2, f"no pool {cmd.get('pool')!r}"
        if enable and app in pool.application:
            return 0, f"application {app!r} already enabled"
        if not enable and app not in pool.application:
            return 0, f"application {app!r} not enabled"
        if enable:
            # only reached when `app` is NOT yet enabled (early return
            # above): the guard fires on "a different app already set"
            if pool.application \
                    and cmd.get("sure") != "--yes-i-really-mean-it":
                other = next(iter(pool.application))
                return -1, (f"pool {pool.name!r} already has application "
                            f"{other!r}; pass --yes-i-really-mean-it to "
                            f"enable a second one")
            pool.application[app] = {}
        else:
            pool.application.pop(app, None)
        verb = "enabled on" if enable else "disabled on"
        return (0, f"application {app!r} {verb} pool {pool.name!r}") \
            if self._propose_map(m) else (-110, "proposal timed out")

    def _cmd_pool_rm(self, cmd: dict) -> tuple[int, object]:
        """`osd pool rm <name> <name> --yes-i-really-really-mean-it`
        (reference: OSDMonitor prepare_command OSD_POOL_DELETE with its
        double-name + sure-flag safety).  OSDs garbage-collect the
        pool's PG collections when the map lands."""
        name = cmd.get("name", "")
        if cmd.get("name2") != name:
            return -1, "pool name must be given twice"
        if cmd.get("sure") != "--yes-i-really-really-mean-it":
            return -1, ("this will PERMANENTLY DESTROY all data; pass "
                        "sure=--yes-i-really-really-mean-it")
        m = self._pending()
        pool = next((p for p in m.pools.values() if p.name == name), None)
        if pool is None:
            return -2, f"no pool {name!r}"
        if pool.tiers:
            return -16, f"pool {name!r} has cache tiers; remove them first"
        if pool.tier_of >= 0:
            return -16, (f"pool {name!r} is a cache tier; "
                         f"`osd tier remove` first")
        pid = pool.pool_id
        del m.pools[pid]
        # scrub per-PG overrides keyed by (pool, ps) — a later pool must
        # not inherit them (reference: OSDMonitor clean_pg_upmaps)
        for ovr in (m.pg_upmap, m.pg_upmap_items, m.pg_temp,
                    m.primary_temp):
            for key in [k for k in ovr if k[0] == pid]:
                del ovr[key]
        return (0, f"pool {name!r} removed") \
            if self._propose_map(m) else (-110, "proposal timed out")

    def _cmd_pool_create(self, cmd: dict) -> tuple[int, object]:
        name = cmd.get("name")
        if not name:
            return -22, "pool name required"
        m = self._pending()
        if any(p.name == name for p in m.pools.values()):
            return -17, f"pool {name!r} already exists"
        pg_num = int(cmd.get("pg_num") or self.mon.cct.conf.get("osd_pool_default_pg_num"))
        pool_id = max(m.max_pool_id, max(m.pools, default=0)) + 1
        kind = cmd.get("pool_type", "replicated")
        # pg-per-osd sanity (reference: mon_max_pg_per_osd check)
        up = sum(1 for o in range(m.max_osd) if m.is_up(o)) or 1
        total_pgs = sum(p.pg_num * p.size for p in m.pools.values())
        limit = self.mon.cct.conf.get("mon_max_pg_per_osd")
        if kind == "erasure":
            prof_name = cmd.get("erasure_code_profile", "default")
            profile = m.ec_profiles.get(prof_name)
            if profile is None:
                return -2, f"no erasure-code profile {prof_name!r}"
            try:
                codec = ErasureCodePluginRegistry.instance().factory(
                    profile, device=self.mon.cct.device)
            except InvalidProfile as e:
                return -22, str(e)
            size = codec.get_chunk_count()
            if (total_pgs + pg_num * size) / up > limit:
                return -34, f"would exceed mon_max_pg_per_osd {limit}"
            # EC crush rule: indep over the profile's failure domain
            # (reference: OSDMonitor::crush_rule_create_erasure)
            rule_id = self._create_rule(
                m, f"{name}_rule",
                profile.get("crush-failure-domain", "host"),
                firstn=False,
            )
            pool = m.create_pool(
                pool_id, pg_num=pg_num, size=size, crush_rule=rule_id,
                type=PG_POOL_ERASURE, name=name, ec_profile=prof_name,
            )
        else:
            size = int(cmd.get("size") or self.mon.cct.conf.get("osd_pool_default_size"))
            if (total_pgs + pg_num * size) / up > limit:
                return -34, f"would exceed mon_max_pg_per_osd {limit}"
            rule_id = self._create_rule(
                m, f"{name}_rule", cmd.get("crush_failure_domain", "host"),
                firstn=True,
            )
            extra = {}
            try:
                if cmd.get("min_size") is not None:
                    ms = int(cmd["min_size"])
                    if not (1 <= ms <= size):
                        return -22, f"min_size {ms} out of [1, size={size}]"
                    extra["min_size"] = ms
                else:
                    # osd_pool_default_min_size: 0 keeps the derived
                    # size - size//2 quorum (PGPool.__post_init__)
                    dms = int(self.mon.cct.conf.get(
                        "osd_pool_default_min_size"))
                    if dms:
                        extra["min_size"] = max(1, min(dms, size))
            except (TypeError, ValueError):
                return -22, "integer min_size required"
            pool = m.create_pool(
                pool_id, pg_num=pg_num, size=size, crush_rule=rule_id,
                type=PG_POOL_REPLICATED, name=name, **extra,
            )
        if not self._propose_map(m):
            return -110, "proposal timed out"
        return 0, {"pool_id": pool.pool_id, "name": name, "size": size,
                   "pg_num": pg_num, "crush_rule": rule_id}

    def _create_rule(self, m: OSDMap, name: str, failure_domain: str,
                     firstn: bool) -> int:
        # reuse an existing rule with identical shape if one exists
        rule_id = max(m.crush.map.rules, default=-1) + 1
        try:
            ftype = m.crush.type_id(failure_domain)
        except KeyError:
            ftype = 1  # host
        add_simple_rule(m.crush.map, -1, ftype, rule_id=rule_id, firstn=firstn)
        m.crush.invalidate()
        return rule_id

    def _cmd_osd_state(self, action: str, cmd: dict) -> tuple[int, object]:
        # `ids` marks a whole cohort in ONE map epoch / one proposal —
        # a cascading failure is one event, and a thousand-OSD storm
        # cannot afford a paxos round trip per member (reference: a
        # real mon batches many down marks into a single epoch too)
        raw = cmd.get("ids") if cmd.get("ids") is not None \
            else [cmd.get("id")]
        try:
            ids = [int(o) for o in raw]
        except (TypeError, ValueError):
            return -22, f"bad osd ids {raw!r}"
        max_osd = self.osdmap.max_osd if self.osdmap else 0
        if not ids or any(not (0 <= o < max_osd) for o in ids):
            return -22, f"bad osd ids {raw!r}"
        m = self._pending()
        for osd in ids:
            if action == "down":
                m.mark_down(osd)
                self._down_stamp[osd] = time.monotonic()
            elif action == "out":
                m.mark_out(osd)
            else:
                m.mark_in(osd)
        if not self._propose_map(m):
            return -110, "proposal timed out"
        if len(ids) == 1:
            return 0, f"marked {action} osd.{ids[0]}"
        return 0, f"marked {action} {len(ids)} osds"

    def _cmd_upmap_items(self, cmd: dict) -> tuple[int, object]:
        try:
            pool_id, ps = int(cmd["pool"]), int(cmd["ps"])
            pairs = [(int(a), int(b)) for a, b in cmd["mappings"]]
        except (KeyError, TypeError, ValueError) as e:
            return -22, f"bad pg-upmap-items args: {e}"
        m = self._pending()
        if pool_id not in m.pools:
            return -2, f"no pool {pool_id}"
        if pairs:
            m.pg_upmap_items[(pool_id, ps)] = pairs
        else:
            m.pg_upmap_items.pop((pool_id, ps), None)
        if not self._propose_map(m):
            return -110, "proposal timed out"
        return 0, f"set {len(pairs)} upmap items on {pool_id}.{ps:x}"
