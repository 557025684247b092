"""OSDMap analog — epoch-versioned pool/PG/OSD placement state.

Reference: src/osd/OSDMap.{h,cc} :: OSDMap, pg_pool_t (src/osd/osd_types.h).
The placement pipeline mirrored here is SURVEY.md §3.3's single-mapping call
stack:

    pg_to_up_acting_osds
      → _pg_to_raw_osds:  ps → pps placement seed (ceph_stable_mod +
                          crush_hash32_2, pg_pool_t::raw_pg_to_pps with the
                          modern FLAG_HASHPSPOOL behavior)
      → CrushWrapper::do_rule with the osd reweight vector
      → _apply_upmap:     pg_upmap / pg_upmap_items overrides
      → _raw_to_up_osds:  drop non-existent/down OSDs (compact for
                          replicated, positional ITEM_NONE holes for EC)
      → _apply_primary_affinity (hash-thinned primary pick)
      → pg_temp / primary_temp acting overrides

plus the batched sibling `map_pool` that runs the CRUSH descent for every PG
of a pool in one crush_do_rule_batch call on the map's device (``cuda``
unless the map was given ``device="cpu"``: the straw2 draws run in K3, the
path consumed by the balancer and the osdmaptool analog, SURVEY.md §1
seam #2).

Provenance caveat (SURVEY.md §0): the reference mount was empty; semantics
are written from documented OSDMap behavior and enforced internally — the
scalar path and the batched path must agree exactly (tests/test_osdmap.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..common.device import resolve_device
from ..crush import CrushWrapper, ITEM_NONE
from ..crush.hash import crush_hash32_2_np

#: pg_pool_t::TYPE_* (reference: src/osd/osd_types.h)
PG_POOL_REPLICATED = 1
PG_POOL_ERASURE = 3

#: osd_state bits (reference: src/osd/OSDMap.h CEPH_OSD_EXISTS/UP)
OSD_EXISTS = 1
OSD_UP = 2

#: 16.16 fixed-point unity (reference: CEPH_OSD_IN / MAX_PRIMARY_AFFINITY)
OSD_IN = 0x10000
MAX_PRIMARY_AFFINITY = 0x10000


def pg_num_mask(pg_num: int) -> int:
    """reference: pg_pool_t::calc_pg_masks — (1 << bits_of(pg_num-1)) - 1."""
    if pg_num <= 0:
        raise ValueError("pg_num must be positive")
    return (1 << (pg_num - 1).bit_length()) - 1


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """reference: src/include/rados.h :: ceph_stable_mod — stable modulo so
    growing pg_num splits PGs instead of reshuffling them."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def _stable_mod_np(x: np.ndarray, b: int, bmask: int) -> np.ndarray:
    lo = x & np.uint32(bmask)
    return np.where(lo < b, lo, x & np.uint32(bmask >> 1))


def object_ps(oid: str, pg_num: int) -> int:
    """Object name -> placement seed (reference: ceph_str_hash + stable_mod
    in OSDMap::object_locator_to_pg).

    crc32c stands in for the rjenkins string hash: it is stable, fast, and
    shared with the C++ oracle; only stability matters for placement."""
    from ..common.crc32c import crc32c

    h = crc32c(oid.encode())
    return ceph_stable_mod(h, pg_num, pg_num_mask(pg_num))


@dataclass
class PGPool:
    """reference: src/osd/osd_types.h :: pg_pool_t (placement fields plus
    the pool-snapshot registry: snap_seq is the latest issued snap id,
    snaps maps live ids to names — reference: pg_pool_t::snaps/snap_seq)."""

    pool_id: int
    pg_num: int
    size: int
    crush_rule: int
    type: int = PG_POOL_REPLICATED
    min_size: int = 0
    pgp_num: int = 0  # 0 → pg_num
    ec_profile: str | None = None  # profile name for erasure pools
    name: str = ""
    snap_seq: int = 0
    snaps: dict = field(default_factory=dict)  # snapid -> name
    # cache tiering (reference: pg_pool_t::tier_of / read_tier /
    # write_tier / cache_mode / tiers).  A CACHE pool has tier_of >= 0
    # pointing at its base; the BASE pool lists its tiers and, once an
    # overlay is set, carries read_tier/write_tier so the Objecter
    # redirects client I/O to the cache (Objecter::_calc_target).
    tier_of: int = -1
    tiers: list = field(default_factory=list)
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = "none"  # none | writeback | readproxy
    # agent thresholds (reference: pg_pool_t::target_max_objects and the
    # TierAgentState full/evict effort derived from it)
    target_max_objects: int = 0
    # pool quotas (reference: pg_pool_t::quota_max_bytes/objects + the
    # FLAG_FULL_QUOTA the mon sets when stats cross them); `flags`
    # carries pool flags, e.g. "full_quota"
    quota_max_bytes: int = 0
    quota_max_objects: int = 0
    flags: list = field(default_factory=list)
    # enabled applications, app -> metadata (reference:
    # pg_pool_t::application_metadata + the POOL_APP_NOT_ENABLED check)
    application: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.pgp_num:
            self.pgp_num = self.pg_num
        if not self.min_size:
            # replicated: the reference's default write quorum is
            # size - size/2 (1 for size-2 pools — a degraded pair still
            # takes writes); EC keeps k (= size - 1 parity short)
            self.min_size = (
                self.size - self.size // 2
                if self.type == PG_POOL_REPLICATED else self.size - 1
            )
        if not self.name:
            self.name = f"pool{self.pool_id}"
        # JSON round-trips dict keys as strings
        self.snaps = {int(k): v for k, v in (self.snaps or {}).items()}
        # mutable fields must be COPIES: _pending()'s vars()/**kwargs
        # round-trip would otherwise alias the committed map's lists and
        # a failed proposal's mutation would leak into committed state
        self.flags = list(self.flags or [])
        self.tiers = list(self.tiers or [])
        self.application = dict(self.application or {})

    def raw_pg_to_pps(self, ps: int) -> int:
        """reference: pg_pool_t::raw_pg_to_pps, FLAG_HASHPSPOOL branch —
        hash the stable-modded seed with the pool id so co-sized pools
        don't stack their PGs on the same OSDs."""
        seed = ceph_stable_mod(ps, self.pgp_num, pg_num_mask(self.pgp_num))
        return int(crush_hash32_2_np(np.uint32(seed), np.uint32(self.pool_id)))

    def raw_pg_to_pps_batch(self, ps: np.ndarray) -> np.ndarray:
        seed = _stable_mod_np(
            np.asarray(ps, np.uint32), self.pgp_num, pg_num_mask(self.pgp_num)
        )
        return crush_hash32_2_np(seed, np.uint32(self.pool_id))


class OSDMap:
    """The cluster map: CRUSH + pools + per-OSD state + upmap overrides."""

    def __init__(self, crush: CrushWrapper, max_osd: int = 0, device=None):
        # the device map_pool's CRUSH descent runs on (cuda unless "cpu")
        self.device = device
        self.epoch = 1
        self.crush = crush
        self.max_osd = max_osd or crush.map.max_devices
        self.osd_state = [OSD_EXISTS | OSD_UP] * self.max_osd
        self.osd_weight = [OSD_IN] * self.max_osd  # in/out reweight, 16.16
        self.osd_primary_affinity = [MAX_PRIMARY_AFFINITY] * self.max_osd
        self.pools: dict[int, PGPool] = {}
        # highest pool id EVER allocated — never reused, so a deleted
        # pool's id cannot alias a later pool in collections/upmaps
        # (reference: OSDMap pool ids are monotonic)
        self.max_pool_id = 0
        # (pool, ps) → explicit raw mapping (reference: OSDMap pg_upmap)
        self.pg_upmap: dict[tuple[int, int], list[int]] = {}
        # (pool, ps) → [(from, to), ...] (reference: pg_upmap_items)
        self.pg_upmap_items: dict[tuple[int, int], list[tuple[int, int]]] = {}
        # acting-set overrides (reference: OSDMap pg_temp / primary_temp)
        self.pg_temp: dict[tuple[int, int], list[int]] = {}
        self.primary_temp: dict[tuple[int, int], int] = {}
        # osd -> (host, port) messenger address (reference: OSDMap
        # osd_addrs — how clients locate a mapped OSD)
        self.osd_addrs: dict[int, tuple[str, int]] = {}
        # cephx service-key GENERATIONS (reference: the rotating secrets
        # CephxKeyServer distributes — here each generation's key derives
        # deterministically from the cluster secret, so bumping the
        # generation IN THE MAP rotates every daemon atomically with the
        # map push and needs no key-distribution protocol)
        self.auth_gens: dict[str, int] = {}
        # cluster-wide flags, e.g. "noout"/"nodown" (reference: OSDMap
        # get_flags / CEPH_OSDMAP_NOOUT)
        self.flags: set[str] = set()
        # EC profiles live in the OSDMap, not daemon config (reference:
        # OSDMap::erasure_code_profiles; SURVEY.md §5.6)
        self.ec_profiles: dict[str, dict] = {}

    # -- state management --------------------------------------------------
    def create_pool(
        self,
        pool_id: int,
        pg_num: int,
        size: int,
        crush_rule: int,
        type: int = PG_POOL_REPLICATED,
        **kw,
    ) -> PGPool:
        """reference: OSDMonitor::prepare_new_pool (validation subset)."""
        if pool_id in self.pools:
            raise ValueError(f"pool {pool_id} exists")
        if crush_rule not in self.crush.map.rules:
            raise ValueError(f"no crush rule {crush_rule}")
        p = PGPool(pool_id, pg_num, size, crush_rule, type=type, **kw)
        self.pools[pool_id] = p
        self.max_pool_id = max(self.max_pool_id, pool_id)
        return p

    def is_up(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_state[osd] & OSD_UP)

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_state[osd] & OSD_EXISTS)

    def is_in(self, osd: int) -> bool:
        """reference: OSDMap::is_in — nonzero reweight."""
        return self.exists(osd) and self.osd_weight[osd] != 0

    def mark_down(self, osd: int) -> None:
        """reference: OSDMonitor failure handling — down keeps CRUSH weight;
        the PG maps elsewhere only once the OSD is also marked out."""
        self.osd_state[osd] &= ~OSD_UP
        self.epoch += 1

    def mark_up(self, osd: int) -> None:
        self.osd_state[osd] |= OSD_UP | OSD_EXISTS
        self.epoch += 1

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0
        self.epoch += 1

    def mark_in(self, osd: int) -> None:
        self.osd_weight[osd] = OSD_IN
        self.epoch += 1

    def set_primary_affinity(self, osd: int, aff: float) -> None:
        self.osd_primary_affinity[osd] = int(aff * MAX_PRIMARY_AFFINITY)
        self.epoch += 1

    # -- scalar mapping path (ground truth) --------------------------------
    def pg_to_raw_osds(self, pool: PGPool, ps: int) -> tuple[list[int], int]:
        """reference: OSDMap::_pg_to_raw_osds — CRUSH with the reweight
        vector; returns (raw osds, pps seed)."""
        pps = pool.raw_pg_to_pps(ps)
        raw = self.crush.do_rule(pool.crush_rule, pps, pool.size, self.osd_weight)
        return raw, pps

    def _upmap_valid_target(self, osd: int) -> bool:
        # reference: OSDMap::_apply_upmap — targets must exist and not be
        # marked out (weight 0), else the override is ignored.
        return self.exists(osd) and self.osd_weight[osd] != 0

    def _apply_upmap(self, pool: PGPool, ps: int, raw: list[int]) -> list[int]:
        """reference: OSDMap::_apply_upmap.  A pg_upmap vector whose length
        differs from the pool size is ignored (OSDMonitor rejects such
        entries at set time; tolerating them on load keeps the scalar and
        batch paths — whose output width is pool.size — in agreement)."""
        key = (pool.pool_id, ps)
        forced = self.pg_upmap.get(key)
        if (
            forced
            and len(forced) == pool.size
            and all(self._upmap_valid_target(o) for o in forced)
        ):
            raw = list(forced)
        items = self.pg_upmap_items.get(key)
        if items:
            raw = list(raw)
            for frm, to in items:
                if frm in raw and to not in raw and self._upmap_valid_target(to):
                    raw[raw.index(frm)] = to
        return raw

    def _raw_to_up_osds(self, pool: PGPool, raw: list[int]) -> list[int]:
        """reference: OSDMap::_raw_to_up_osds — drop down/non-existent OSDs:
        compact for replicated pools, positional NONE holes for EC (shard
        identity is positional, SURVEY.md §3.2)."""
        def ok(o: int) -> bool:
            return o >= 0 and self.exists(o) and self.is_up(o)

        if pool.type == PG_POOL_ERASURE:
            return [o if ok(o) else ITEM_NONE for o in raw]
        return [o for o in raw if ok(o)]

    def _apply_primary_affinity(self, pps: int, up: list[int]) -> int:
        """reference: OSDMap::_apply_primary_affinity — each up OSD in order
        keeps the primary role with probability affinity/0x10000, decided by
        a pps-seeded hash so the choice is deterministic per PG."""
        pos = -1
        for i, o in enumerate(up):
            if o < 0:
                continue
            a = self.osd_primary_affinity[o]
            if a < MAX_PRIMARY_AFFINITY and (
                int(crush_hash32_2_np(np.uint32(pps), np.uint32(o))) >> 16
            ) >= a:
                continue
            pos = i
            break
        if pos < 0:  # every candidate declined → fall back to first up OSD
            for i, o in enumerate(up):
                if o >= 0:
                    return o
            return ITEM_NONE
        return up[pos]

    def pg_to_up_acting_osds(
        self, pool_id: int, ps: int
    ) -> tuple[list[int], int, list[int], int]:
        """reference: OSDMap::pg_to_up_acting_osds — returns
        (up, up_primary, acting, acting_primary)."""
        pool = self.pools[pool_id]
        raw, pps = self.pg_to_raw_osds(pool, ps)
        raw = self._apply_upmap(pool, ps, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._apply_primary_affinity(pps, up)
        acting = self.pg_temp.get((pool_id, ps)) or up
        acting_primary = self.primary_temp.get((pool_id, ps))
        if acting_primary is None:
            if acting is up:
                acting_primary = up_primary
            else:
                acting_primary = next((o for o in acting if o >= 0), ITEM_NONE)
        return up, up_primary, list(acting), acting_primary

    # -- batched mapping path (the card) -----------------------------------
    def map_pool(self, pool_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Map every PG of a pool in one batched CRUSH launch.

        Returns (up [pg_num, size] with ITEM_NONE fill, up_primary [pg_num]).
        The CRUSH descent — HOT LOOP #3 — runs on device via
        crush_do_rule_batch; the sparse upmap/temp overrides and the up/
        affinity filters are cheap vectorized host post-passes, exactly the
        split SURVEY.md §3.3 prescribes for the batch consumers."""
        pool = self.pools[pool_id]
        ps = np.arange(pool.pg_num, dtype=np.uint32)
        pps = pool.raw_pg_to_pps_batch(ps)
        self.device = resolve_device(self.device)
        raw = (
            self.crush.do_rule_batch(
                pool.crush_rule,
                pps.astype(np.int32),
                pool.size,
                self.osd_weight,
                device=self.device,
            )
            .cpu()
            .numpy()
            .astype(np.int64)
        )

        # sparse per-PG upmap overrides (dict-sized, not pg_num-sized work)
        for (pid, s), forced in self.pg_upmap.items():
            if (
                pid == pool_id
                and s < pool.pg_num
                and len(forced) == pool.size
                and all(self._upmap_valid_target(o) for o in forced)
            ):
                raw[s] = forced
        for (pid, s), items in self.pg_upmap_items.items():
            if pid != pool_id or s >= pool.pg_num:
                continue
            row = list(raw[s])
            for frm, to in items:
                if frm in row and to not in row and self._upmap_valid_target(to):
                    row[row.index(frm)] = to
            raw[s] = row

        # up filter (vectorized): valid = exists & up
        state = np.zeros(self.max_osd + 1, dtype=bool)
        state[:-1] = [
            (st & OSD_UP) and (st & OSD_EXISTS) for st in self.osd_state
        ]
        valid = (raw >= 0) & (raw < self.max_osd) & state[np.clip(raw, 0, self.max_osd)]
        if pool.type == PG_POOL_ERASURE:
            up = np.where(valid, raw, ITEM_NONE)
        else:
            # stable left-compaction of valid entries per row
            order = np.argsort(~valid, axis=1, kind="stable")
            up = np.where(
                np.take_along_axis(valid, order, axis=1),
                np.take_along_axis(raw, order, axis=1),
                ITEM_NONE,
            )

        up_primary = self._primary_batch(pps, up)
        return up.astype(np.int32), up_primary.astype(np.int32)

    def _primary_batch(self, pps: np.ndarray, up: np.ndarray) -> np.ndarray:
        aff = np.asarray(self.osd_primary_affinity + [0], dtype=np.int64)
        present = up >= 0
        if all(a == MAX_PRIMARY_AFFINITY for a in self.osd_primary_affinity):
            accept = present
        else:
            osd_aff = aff[np.clip(up, 0, self.max_osd)]
            h = (
                crush_hash32_2_np(
                    pps[:, None].astype(np.uint32), up.astype(np.uint32)
                ).astype(np.int64)
                >> 16
            )
            accept = present & ((osd_aff >= MAX_PRIMARY_AFFINITY) | (h < osd_aff))
        # first accepted, else first present, else NONE
        def first(mask):
            idx = np.argmax(mask, axis=1)
            ok = mask.any(axis=1)
            return np.where(ok, up[np.arange(len(up)), idx], ITEM_NONE), ok

        prim_a, ok_a = first(accept)
        prim_p, _ = first(present)
        return np.where(ok_a, prim_a, prim_p)

    # -- serialization (osdmaptool surface) --------------------------------
    def to_json(self) -> dict:
        return {
            "epoch": self.epoch,
            "max_osd": self.max_osd,
            "osd_state": list(self.osd_state),
            "osd_weight": list(self.osd_weight),
            "osd_primary_affinity": list(self.osd_primary_affinity),
            "crush_text": self.crush.format_text(),
            # legacy aux tables VERBATIM (advisor r3 / r4 verdict #5):
            # the text format cannot carry straw scaling factors or tree
            # node weights, and re-deriving them on every decode would
            # silently replace tables an ingested map computed under a
            # different straw_calc_version — changing placements across
            # a mon restart.  Reference: crush wire encoding carries the
            # bucket aux arrays; straw_calc_version only governs builds.
            "crush_aux": {
                str(bid): {
                    "straws": list(b.straws),
                    "node_weights": list(b.node_weights),
                }
                for bid, b in self.crush.map.buckets.items()
                if b.straws or b.node_weights
            },
            "pools": [vars(p) for p in self.pools.values()],
            "max_pool_id": self.max_pool_id,
            "pg_upmap": [
                {"pool": k[0], "ps": k[1], "osds": v}
                for k, v in self.pg_upmap.items()
            ],
            "pg_upmap_items": [
                {"pool": k[0], "ps": k[1], "mappings": [list(m) for m in v]}
                for k, v in self.pg_upmap_items.items()
            ],
            "pg_temp": [
                {"pool": k[0], "ps": k[1], "osds": v}
                for k, v in self.pg_temp.items()
            ],
            "primary_temp": [
                {"pool": k[0], "ps": k[1], "osd": v}
                for k, v in self.primary_temp.items()
            ],
            "osd_addrs": [
                {"osd": o, "host": a[0], "port": a[1]}
                for o, a in self.osd_addrs.items()
            ],
            "flags": sorted(self.flags),
            "ec_profiles": self.ec_profiles,
            "auth_gens": self.auth_gens,
        }

    @classmethod
    def from_json(cls, d: dict, device=None) -> "OSDMap":
        m = cls(CrushWrapper.parse_text(d["crush_text"]), d["max_osd"], device=device)
        # restore ingested aux tables verbatim over the parser's
        # re-derived ones (see to_json): length-checked so a corrupt
        # record falls back to the derived tables instead of crashing
        # the mapper later
        for bid_s, aux in (d.get("crush_aux") or {}).items():
            try:
                b = m.crush.map.buckets.get(int(bid_s))
                if b is None or not isinstance(aux, dict):
                    continue
                straws = aux.get("straws") or []
                if straws and len(straws) == len(b.items):
                    b.straws = [int(s) for s in straws]
                nodes = aux.get("node_weights") or []
                # structural validity: a tree's node array length is a
                # power of two covering 2*size leaves — anything else
                # would start descent at an odd root and collapse every
                # draw onto one item
                n = len(nodes)
                if (nodes and n >= 2 * len(b.items)
                        and n & (n - 1) == 0):
                    b.node_weights = [int(x) for x in nodes]
            except (TypeError, ValueError, AttributeError):
                continue  # corrupt record: keep the derived tables
        m.epoch = d.get("epoch", 1)
        m.osd_state = list(d["osd_state"])
        m.osd_weight = list(d["osd_weight"])
        m.osd_primary_affinity = list(d["osd_primary_affinity"])
        for pd in d["pools"]:
            m.pools[pd["pool_id"]] = PGPool(**pd)
        m.max_pool_id = max(int(d.get("max_pool_id", 0)),
                            max(m.pools, default=0))
        for e in d.get("pg_upmap", []):
            m.pg_upmap[(e["pool"], e["ps"])] = list(e["osds"])
        for e in d.get("pg_upmap_items", []):
            m.pg_upmap_items[(e["pool"], e["ps"])] = [
                tuple(x) for x in e["mappings"]
            ]
        for e in d.get("pg_temp", []):
            m.pg_temp[(e["pool"], e["ps"])] = list(e["osds"])
        for e in d.get("primary_temp", []):
            m.primary_temp[(e["pool"], e["ps"])] = e["osd"]
        for e in d.get("osd_addrs", []):
            m.osd_addrs[e["osd"]] = (e["host"], e["port"])
        m.flags = set(d.get("flags", []))
        m.ec_profiles = dict(d.get("ec_profiles", {}))
        m.auth_gens = dict(d.get("auth_gens", {}))
        return m
