"""Programmatic CRUSH map construction — builder.c + CrushWrapper rule helpers.

The port's own copy of ceph_tpu/crush/builder.py.

Reference: src/crush/builder.c :: crush_make_straw2_bucket / crush_add_bucket,
and src/crush/CrushWrapper.cc :: add_simple_rule (replicated) plus the EC rule
OSDMonitor creates for erasure pools.  Also the standard test topology
generator used by golden tests (the analog of crushtool --build).
"""
from __future__ import annotations

from .types import (
    BUCKET_LIST,
    BUCKET_STRAW,
    BUCKET_STRAW2,
    BUCKET_TREE,
    BUCKET_UNIFORM,
    CrushMap,
    Rule,
    RuleOp,
    RuleStep,
    Straw2Bucket,
)


def calc_straws(weights: list[int]) -> list[int]:
    """16.16 straw scaling factors for a legacy straw bucket
    (reference: builder.c :: crush_calc_straw).  Items are processed in
    increasing weight order; each distinct weight tier lengthens the
    straws of everything still standing so the expected win probability
    tracks the weights.  (The classic straw algorithm this reproduces is
    the one straw2 replaced precisely because this scaling is only
    approximately fair for some weight patterns.)

    NOTE: the reference mount is empty this round, so this is a
    reconstruction of the published algorithm; what the repo GUARANTEES
    is internal bit-exactness — straws are computed once, here, and all
    three mappers consume the same table."""
    size = len(weights)
    if size == 0:
        return []
    order = sorted(range(size), key=lambda i: (weights[i], i))
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        idx = order[i]
        if weights[idx] == 0:
            straws[idx] = 0
            i += 1
            continue
        straws[idx] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        nxt = order[i]
        if weights[nxt] == weights[idx]:
            continue  # same tier: same straw length
        # close the tier: probability mass below this weight
        wbelow += (float(weights[idx]) - lastw) * numleft
        numleft = size - i  # items still standing (strictly heavier)
        wnext = float(numleft * (weights[nxt] - weights[idx]))
        pbelow = wbelow / (wbelow + wnext)
        straw *= pbelow ** (-1.0 / numleft) if numleft else 1.0
        lastw = float(weights[idx])
    return straws


def calc_tree_nodes(weights: list[int]) -> list[int]:
    """Implicit-binary-tree node weights for a tree bucket (reference:
    builder.c :: crush_make_tree_bucket): leaves live at odd indices
    1,3,..,2i+1; an internal node's weight is the sum of its subtree.
    Array length is 1 << depth where depth covers 2*size slots."""
    size = len(weights)
    if size == 0:
        return []
    depth = 1
    while (1 << depth) < size * 2:
        depth += 1
    nodes = [0] * (1 << depth)
    for i, w in enumerate(weights):
        node = i * 2 + 1
        nodes[node] = w
        n = node
        while n != (1 << (depth - 1)):
            # parent(n): set the bit above the lowest set bit, clear it
            kb = n & -n
            parent = (n | (kb << 1)) & ~kb
            if parent >= len(nodes):
                break
            nodes[parent] += w
            n = parent
    return nodes


def make_straw2_bucket(
    cmap: CrushMap,
    type_id: int,
    items: list[int],
    weights: list[int],
    bucket_id: int | None = None,
    name: str | None = None,
    alg: int = BUCKET_STRAW2,
) -> Straw2Bucket:
    """builder.c :: crush_make_<alg>_bucket + crush_add_bucket — one
    constructor covering all five algorithms (alg selects; straw/tree
    aux tables are derived here, at build time, like the reference
    builder does)."""
    if len(items) != len(weights):
        raise ValueError("items and weights must have equal length")
    if bucket_id is None:
        bucket_id = -1
        while bucket_id in cmap.buckets:
            bucket_id -= 1
    if bucket_id >= 0:
        raise ValueError("bucket ids are negative")
    if bucket_id in cmap.buckets:
        raise ValueError(f"bucket {bucket_id} exists")
    b = Straw2Bucket(id=bucket_id, type=type_id, items=list(items),
                     weights=list(weights), alg=alg)
    if alg == BUCKET_STRAW:
        b.straws = calc_straws(b.weights)
    elif alg == BUCKET_TREE:
        b.node_weights = calc_tree_nodes(b.weights)
    elif alg == BUCKET_UNIFORM and len(set(weights)) > 1:
        raise ValueError("uniform buckets need equal item weights")
    cmap.buckets[bucket_id] = b
    for it in items:
        if it >= 0:
            cmap.max_devices = max(cmap.max_devices, it + 1)
    if name:
        cmap.bucket_names[bucket_id] = name
    return b


def add_simple_rule(
    cmap: CrushMap,
    root: int,
    failure_domain_type: int,
    rule_id: int | None = None,
    firstn: bool = True,
    num_replicas: int = 0,
) -> Rule:
    """CrushWrapper.cc :: add_simple_rule — take root, chooseleaf over the
    failure domain, emit.  num_replicas 0 means 'use the requested numrep'
    (CRUSH_CHOOSE_N)."""
    if rule_id is None:
        rule_id = max(cmap.rules, default=-1) + 1
    op = RuleOp.CHOOSELEAF_FIRSTN if firstn else RuleOp.CHOOSELEAF_INDEP
    if failure_domain_type == 0:
        op = RuleOp.CHOOSE_FIRSTN if firstn else RuleOp.CHOOSE_INDEP
    rule = Rule(
        rule_id=rule_id,
        type=1 if firstn else 3,
        steps=[
            RuleStep(RuleOp.TAKE, root),
            RuleStep(op, num_replicas, failure_domain_type),
            RuleStep(RuleOp.EMIT),
        ],
    )
    cmap.rules[rule_id] = rule
    return rule


def build_flat_map(n_osds: int, device_weight: float = 1.0) -> CrushMap:
    """One root straw2 bucket holding every OSD (simplest useful map)."""
    cmap = CrushMap()
    cmap.type_names.update({1: "root"})
    w = int(device_weight * 0x10000)
    make_straw2_bucket(
        cmap, 1, list(range(n_osds)), [w] * n_osds, bucket_id=-1, name="default"
    )
    cmap.max_devices = n_osds
    add_simple_rule(cmap, -1, 0, rule_id=0)
    return cmap


def build_hierarchical_map(
    n_hosts: int,
    osds_per_host: int,
    device_weight: float = 1.0,
    firstn: bool = True,
    racks: int = 0,
) -> CrushMap:
    """root -> (racks ->) hosts -> osds, replicated + erasure rules.

    The standard topology of the reference's CRUSH tests (reference:
    src/test/crush/crush.cc builds analogous root/host trees).
    """
    cmap = CrushMap()
    cmap.type_names.update({1: "host", 2: "rack", 10: "root"})
    w = int(device_weight * 0x10000)
    host_ids = []
    osd = 0
    for h in range(n_hosts):
        items = list(range(osd, osd + osds_per_host))
        osd += osds_per_host
        b = make_straw2_bucket(
            cmap, 1, items, [w] * len(items), bucket_id=-(h + 2), name=f"host{h}"
        )
        host_ids.append(b.id)
    top_children = host_ids
    if racks:
        rack_ids = []
        per = max(1, n_hosts // racks)
        for r in range(racks):
            hs = host_ids[r * per : (r + 1) * per] or host_ids[-1:]
            b = make_straw2_bucket(
                cmap,
                2,
                hs,
                [cmap.buckets[h].weight for h in hs],
                bucket_id=-(n_hosts + 2 + r),
                name=f"rack{r}",
            )
            rack_ids.append(b.id)
        top_children = rack_ids
    make_straw2_bucket(
        cmap,
        10,
        top_children,
        [cmap.buckets[c].weight for c in top_children],
        bucket_id=-1,
        name="default",
    )
    cmap.max_devices = osd
    add_simple_rule(cmap, -1, 1, rule_id=0, firstn=firstn)
    # erasure-style indep rule over hosts (OSDMonitor's EC rule shape)
    add_simple_rule(cmap, -1, 1, rule_id=1, firstn=False)
    return cmap
