"""CRUSH map data model — crush.h structs re-done as Python dataclasses.

The port's own copy of ceph_tpu/crush/types.py (the port imports nothing
of ceph_tpu).

Reference: src/crush/crush.h :: crush_map, crush_bucket_* variants,
crush_rule, crush_rule_step.  All five bucket algorithms are modeled:
straw2 (the default and recommended algorithm since Hammer), plus the
legacy uniform/list/tree/straw types real decompiled maps still carry
(allowed_bucket_algs in
the modern tunable profiles), and the balancer/upmap machinery the north star
accelerates assumes it.  Bucket ids are negative (-1-index), devices are
non-negative ints, exactly as in the reference.

Tunables: the modern ("jewel"/default) profile is the supported semantics —
choose_local_tries=0, choose_local_fallback_tries=0, choose_total_tries=50,
chooseleaf_descend_once=1, chooseleaf_vary_r=1, chooseleaf_stable=1
(reference: src/crush/CrushWrapper.h set_tunables_jewel; legacy pre-Hammer
retry modes are intentionally out of scope).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum


class RuleOp(IntEnum):
    """reference: crush.h :: crush_rule_step op codes (subset: the ops
    emitted by modern CrushWrapper rule builders)."""

    NOOP = 0
    TAKE = 1
    CHOOSE_FIRSTN = 2
    CHOOSE_INDEP = 3
    EMIT = 4
    CHOOSELEAF_FIRSTN = 6
    CHOOSELEAF_INDEP = 7
    SET_CHOOSE_TRIES = 8
    SET_CHOOSELEAF_TRIES = 9


#: out[] sentinel values (reference: crush.h CRUSH_ITEM_UNDEF/NONE)
ITEM_UNDEF = -0x7FFFFFFF
ITEM_NONE = -0x7FFFFFFE


#: bucket algorithms (reference: crush.h CRUSH_BUCKET_*)
BUCKET_UNIFORM = 1
BUCKET_LIST = 2
BUCKET_TREE = 3
BUCKET_STRAW = 4
BUCKET_STRAW2 = 5

BUCKET_ALG_NAMES = {
    BUCKET_UNIFORM: "uniform", BUCKET_LIST: "list", BUCKET_TREE: "tree",
    BUCKET_STRAW: "straw", BUCKET_STRAW2: "straw2",
}


@dataclass
class Straw2Bucket:
    """reference: crush.h :: crush_bucket_straw2 and siblings (the
    crush_bucket header + per-alg payload).  The class predates the
    legacy algorithms and keeps its name; `alg` selects the choose
    function.  Aux fields:
    - straw buckets carry `straws` (16.16 scaling factors derived from
      the weights at build time, reference: builder.c crush_calc_straw);
    - tree buckets carry `node_weights` (the implicit binary tree of
      builder.c, leaves at odd indices, internal nodes summing children);
    - uniform buckets treat weights[0] as the shared item weight."""

    id: int  # negative
    type: int  # bucket type id (>0; devices are type 0)
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)  # 16.16 fixed-point
    hash_id: int = 0  # CRUSH_HASH_RJENKINS1
    alg: int = BUCKET_STRAW2
    straws: list[int] = field(default_factory=list)        # straw only
    node_weights: list[int] = field(default_factory=list)  # tree only

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)


@dataclass
class RuleStep:
    op: RuleOp
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    """reference: crush.h :: crush_rule; rule_id selects it from the pool."""

    rule_id: int
    steps: list[RuleStep] = field(default_factory=list)
    type: int = 1  # 1=replicated, 3=erasure (pg_pool_t convention)


@dataclass
class Tunables:
    choose_total_tries: int = 50
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1


@dataclass
class CrushMap:
    """reference: crush.h :: crush_map."""

    buckets: dict[int, Straw2Bucket] = field(default_factory=dict)
    rules: dict[int, Rule] = field(default_factory=dict)
    max_devices: int = 0
    type_names: dict[int, str] = field(default_factory=lambda: {0: "osd"})
    bucket_names: dict[int, str] = field(default_factory=dict)
    device_names: dict[int, str] = field(default_factory=dict)
    tunables: Tunables = field(default_factory=Tunables)
    #: device classes (reference: CrushWrapper class_map / class_name):
    #: class id -> name, osd id -> class id
    class_names: dict[int, str] = field(default_factory=dict)
    device_classes: dict[int, int] = field(default_factory=dict)
    #: shadow trees per class (reference: CrushWrapper::class_bucket,
    #: device_class_clone): original bucket id -> class id -> shadow id
    class_bucket: dict[int, dict[int, int]] = field(default_factory=dict)
    #: choose_args weight-sets (reference: crush.h :: crush_choose_arg_map;
    #: the balancer's crush-compat mode writes these): name ->
    #: {bucket id -> weight_set [positions][bucket size] 16.16}.  Item-id
    #: remapping (crush_choose_arg::ids) is not modeled — the balancer only
    #: adjusts weights.
    choose_args: dict[str, dict[int, list[list[int]]]] = field(
        default_factory=dict
    )

    def bucket(self, bid: int) -> Straw2Bucket:
        return self.buckets[bid]

    def item_type(self, item: int) -> int:
        return 0 if item >= 0 else self.buckets[item].type

    def max_depth(self) -> int:
        """Longest bucket chain — static bound for the vectorized descent."""

        def depth(bid: int, seen: frozenset[int]) -> int:
            if bid >= 0:
                return 0
            if bid in seen:
                raise ValueError(f"bucket cycle at {bid}")
            b = self.buckets[bid]
            if not b.items:
                return 1
            return 1 + max(depth(i, seen | {bid}) for i in b.items)

        roots = set(self.buckets)
        for b in self.buckets.values():
            roots -= set(i for i in b.items if i < 0)
        if not roots:
            return 0
        return max(depth(r, frozenset()) for r in roots)
