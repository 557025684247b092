"""Scalar CRUSH mapper — the Python mirror of mapper.c, semantic ground truth.

The port's own copy of ceph_tpu/crush/reference_mapper.py.  Reference:
src/crush/mapper.c :: crush_do_rule, crush_choose_firstn,
crush_choose_indep, the per-algorithm bucket chooses (straw2 plus the
legacy uniform/list/tree/straw types), is_out.  It is the referee of the
port's batched mapper (crush/mapper.py), and the mapper of single
placements (CrushWrapper.do_rule): both must agree bit for bit.

Implemented tunable profile: the modern defaults (Tunables dataclass) —
choose_local_tries=0 and choose_local_fallback_tries=0 collapse the
legacy local-retry modes, so on collision/rejection the descent restarts
from the TAKE bucket with r' = r + ftotal (firstn) or r + numrep*ftotal
(indep), bounded by choose_total_tries.  chooseleaf_stable=1 and
chooseleaf_vary_r=1 semantics are implemented for the recursive leaf step.
"""
from __future__ import annotations

from .ln_table import CRUSH_LN_TABLE, LN_BIAS
from .types import (
    BUCKET_LIST,
    BUCKET_STRAW,
    BUCKET_STRAW2,
    BUCKET_TREE,
    BUCKET_UNIFORM,
    ITEM_NONE,
    CrushMap,
    RuleOp,
    Straw2Bucket,
)

S64_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF
_SEED = 1315423911


def _mix_int(a: int, b: int, c: int) -> tuple[int, int, int]:
    """crush_hashmix over plain ints (mod 2^32) — fast scalar path."""
    a = (a - b - c) & _M32
    a ^= c >> 13
    b = (b - c - a) & _M32
    b ^= (a << 8) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 13
    a = (a - b - c) & _M32
    a ^= c >> 12
    b = (b - c - a) & _M32
    b ^= (a << 16) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 5
    a = (a - b - c) & _M32
    a ^= c >> 3
    b = (b - c - a) & _M32
    b ^= (a << 10) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 15
    return a, b, c


def _hash3(x: int, b: int, r: int) -> int:
    """crush_hash32_rjenkins1_3 over plain ints."""
    a, b, c = x & _M32, b & _M32, r & _M32
    h = _SEED ^ a ^ b ^ c
    x_, y = 231232, 1232
    a, b, h = _mix_int(a, b, h)
    c, x_, h = _mix_int(c, x_, h)
    y, a, h = _mix_int(y, a, h)
    b, x_, h = _mix_int(b, x_, h)
    y, c, h = _mix_int(y, c, h)
    return h


def _hash4(a: int, b: int, c: int, d: int) -> int:
    """hash.c :: crush_hash32_rjenkins1_4 over plain ints (the tensor
    twin in crush/hash.py is for lanes; these scalar loops need the
    sub-microsecond path like _hash2/_hash3 above)."""
    a, b, c, d = a & _M32, b & _M32, c & _M32, d & _M32
    h = (_SEED ^ a ^ b ^ c ^ d) & _M32
    x, y = 231232, 1232
    a, b, h = _mix_int(a, b, h)
    c, d, h = _mix_int(c, d, h)
    a, x, h = _mix_int(a, x, h)
    y, b, h = _mix_int(y, b, h)
    c, x, h = _mix_int(c, x, h)
    y, d, h = _mix_int(y, d, h)
    return h


def _hash2(a: int, b: int) -> int:
    """crush_hash32_rjenkins1_2 over plain ints."""
    a, b = a & _M32, b & _M32
    h = _SEED ^ a ^ b
    x_, y = 231232, 1232
    a, b, h = _mix_int(a, b, h)
    x_, a, h = _mix_int(x_, a, h)
    b, y, h = _mix_int(b, y, h)
    return h


def _div_trunc(a: int, b: int) -> int:
    """C-style truncating s64 division (div64_s64)."""
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return q


def _arg_weights(choose_args, bucket: Straw2Bucket, position: int):
    """Weight vector for a bucket under a choose_args weight-set
    (reference: mapper.c :: get_choose_arg_weights — position clamps to the
    last weight_set row).  None -> the bucket's own weights."""
    if not choose_args:
        return None
    ws = choose_args.get(bucket.id)
    if not ws:
        return None
    return ws[min(position, len(ws) - 1)]


def bucket_straw2_choose(
    bucket: Straw2Bucket, x: int, r: int, weights=None
) -> int:
    """mapper.c :: bucket_straw2_choose — max of ln(u)/w fixed-point draws.

    ln = crush_ln(u) - 2^48 is negative (log2 of u/2^16 in 16.44 fixed
    point); dividing by the 16.16 item weight makes larger weights less
    negative, so argmax favors heavier items with exactly the exponential
    race distribution.  Zero-weight items draw S64_MIN.  `weights`
    substitutes a choose_args weight_set row for the bucket's own weights.
    """
    if weights is None:
        weights = bucket.weights
    high = 0
    high_draw = 0
    for i, (item, weight) in enumerate(zip(bucket.items, weights)):
        if weight:
            u = _hash3(x, item, r) & 0xFFFF
            ln = int(CRUSH_LN_TABLE[u]) - LN_BIAS
            draw = _div_trunc(ln, weight)
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_uniform_choose(bucket, work: dict, x: int, r: int) -> int:
    """mapper.c :: bucket_perm_choose — uniform buckets pick via a lazily
    built pseudo-random permutation CACHED PER (bucket, x) in the
    rule-invocation work space (reference: crush_work_bucket).  The
    cache is semantic, not an optimization: mixing r values for one x
    must walk ONE permutation, including the optimized r==0 shortcut's
    cleanup, to reproduce mapper.c bit-for-bit."""
    size = bucket.size
    pr = r % size
    st = work.setdefault(bucket.id, {"perm_x": None, "perm_n": 0, "perm": []})
    if st["perm_x"] != x or st["perm_n"] == 0:
        st["perm_x"] = x
        if pr == 0:
            s0 = _hash3(x, bucket.id, 0) % size
            st["perm"] = [s0]
            st["perm_n"] = 0xFFFF  # magic: only slot 0 materialized
            return bucket.items[s0]
        st["perm"] = list(range(size))
        st["perm_n"] = 0
    elif st["perm_n"] == 0xFFFF:
        # clean up after the r==0 shortcut: materialize the identity and
        # swap slot 0's winner into place
        s0 = st["perm"][0]
        st["perm"] = list(range(size))
        st["perm"][0], st["perm"][s0] = st["perm"][s0], st["perm"][0]
        st["perm_n"] = 1
    perm = st["perm"]
    while st["perm_n"] <= pr:
        p = st["perm_n"]
        if p < size - 1:
            i = _hash3(x, bucket.id, p) % (size - p)
            if i:
                perm[p], perm[p + i] = perm[p + i], perm[p]
        st["perm_n"] += 1
    return bucket.items[perm[pr]]


def bucket_list_choose(bucket, x: int, r: int) -> int:
    """mapper.c :: bucket_list_choose — walk from the TAIL; each item
    wins with probability weight/sum-so-far via a 16-bit draw scaled by
    the cumulative weight."""
    cum = 0
    sums = []
    for w in bucket.weights:
        cum += w
        sums.append(cum)
    for i in range(bucket.size - 1, -1, -1):
        w = _hash4(x, bucket.items[i], r, bucket.id) & 0xFFFF
        w = (w * sums[i]) >> 16
        if w < bucket.weights[i]:
            return bucket.items[i]
    return bucket.items[0]  # "bad list sums" fallback


def bucket_tree_choose(bucket, x: int, r: int) -> int:
    """mapper.c :: bucket_tree_choose — descend the implicit binary tree
    (leaves at odd indices), hashing a split point against the left
    subtree's weight at each internal node."""
    nodes = bucket.node_weights
    # root = num_nodes >> 1, unconditionally (mapper.c) — no zero-weight
    # collapse (advisor r3).  A weighted descent can never reach an
    # empty leaf: t in [0, w) and the left subtree holds all of w when
    # the right is empty, so t < left always steers left.  The one
    # exception is an ALL-ZERO tree (t = 0, comparisons all false,
    # descend right into padding) — upstream reads out-of-bounds there;
    # we pin that degenerate case to the last real item.
    n = len(nodes) >> 1
    while not (n & 1):
        w = nodes[n]
        t = (_hash4(x, n, r, bucket.id) * w) >> 32
        h = (n & -n) >> 1  # half the subtree span
        left = n - h
        n = left if t < nodes[left] else n + h
    return bucket.items[min(n >> 1, len(bucket.items) - 1)]


def bucket_straw_choose(bucket, x: int, r: int) -> int:
    """mapper.c :: bucket_straw_choose — 16-bit draw times the
    build-time straw scaling factor; longest straw wins."""
    high = 0
    high_draw = -1
    for i, item in enumerate(bucket.items):
        draw = (_hash3(x, item, r) & 0xFFFF) * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_choose(bucket, x: int, r: int, weights=None,
                  work: dict | None = None) -> int:
    """Per-algorithm dispatch (mapper.c :: crush_bucket_choose).
    choose_args weight-set overrides apply to straw2 only — the legacy
    algorithms predate weight sets."""
    alg = getattr(bucket, "alg", BUCKET_STRAW2)
    if alg == BUCKET_STRAW2:
        return bucket_straw2_choose(bucket, x, r, weights)
    if alg == BUCKET_STRAW:
        return bucket_straw_choose(bucket, x, r)
    if alg == BUCKET_LIST:
        return bucket_list_choose(bucket, x, r)
    if alg == BUCKET_TREE:
        return bucket_tree_choose(bucket, x, r)
    if alg == BUCKET_UNIFORM:
        return bucket_uniform_choose(bucket, work if work is not None else {},
                                     x, r)
    raise ValueError(f"unknown bucket alg {alg}")


def is_out(cmap: CrushMap, weight: list[int], item: int, x: int) -> bool:
    """mapper.c :: is_out — probabilistic rejection by OSD reweight
    (the `weight` vector is the per-device reweight, 16.16)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (_hash2(x, item) & 0xFFFF) >= w


def _choose_firstn(
    cmap: CrushMap,
    bucket: Straw2Bucket,
    weight: list[int],
    x: int,
    numrep: int,
    type_: int,
    out: list[int],
    outpos: int,
    tries: int,
    recurse_tries: int,
    recurse_to_leaf: bool,
    out2: list[int] | None,
    parent_r: int,
    choose_args=None,
    work: dict | None = None,
) -> int:
    """mapper.c :: crush_choose_firstn under modern tunables."""
    if work is None:
        work = {}
    t = cmap.tunables
    stable = t.chooseleaf_stable
    rep_range = range(0, numrep) if stable else range(outpos, numrep)
    for rep in rep_range:
        ftotal = 0
        skip_rep = False
        item = 0
        while True:  # retry_descent
            in_bucket = bucket
            r = rep + parent_r + ftotal
            reject = False
            collide = False
            while True:  # descend / retry_bucket
                if in_bucket.size == 0:
                    reject = True
                    break
                item = bucket_choose(
                    in_bucket, x, r,
                    _arg_weights(choose_args, in_bucket, outpos),
                    work,
                )
                itemtype = cmap.item_type(item)
                if itemtype != type_:
                    if item >= 0:
                        # device of the wrong type (mapper.c "bad item type"):
                        # reject and burn a try
                        reject = True
                        break
                    in_bucket = cmap.buckets[item]
                    continue
                collide = item in out[:outpos]
                reject = False
                if not collide and recurse_to_leaf:
                    if item < 0:
                        sub_r = r >> (t.chooseleaf_vary_r - 1) if t.chooseleaf_vary_r else 0
                        out2_pos = _choose_firstn(
                            cmap,
                            cmap.buckets[item],
                            weight,
                            x,
                            1 if stable else outpos + 1,
                            0,
                            out2,
                            outpos,
                            recurse_tries,
                            0,
                            False,
                            None,
                            sub_r,
                            choose_args,
                            work,
                        )
                        if out2_pos <= outpos:
                            reject = True  # didn't get a leaf
                    else:
                        out2[outpos] = item
                if not reject and not collide and itemtype == 0:
                    reject = is_out(cmap, weight, item, x)
                break
            if reject or collide:
                ftotal += 1
                if ftotal < tries:
                    continue  # retry descent from the top
                skip_rep = True
            break
        if skip_rep:
            continue
        out[outpos] = item
        if out2 is not None and cmap.item_type(item) == 0:
            out2[outpos] = item
        outpos += 1
    return outpos


def _choose_indep(
    cmap: CrushMap,
    bucket: Straw2Bucket,
    weight: list[int],
    x: int,
    left: int,
    numrep: int,
    type_: int,
    out: list[int],
    outpos: int,
    tries: int,
    recurse_tries: int,
    recurse_to_leaf: bool,
    out2: list[int] | None,
    parent_r: int,
    choose_args=None,
    work: dict | None = None,
) -> None:
    """mapper.c :: crush_choose_indep — positional (EC) variant; failed
    positions end as ITEM_NONE so shard ids stay stable."""
    if work is None:
        work = {}
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = None  # CRUSH_ITEM_UNDEF stand-in
        if out2 is not None:
            out2[rep] = None
    ftotal = 0
    left_count = left
    while left_count > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] is not None:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r + numrep * ftotal
                if in_bucket.size == 0:
                    # structural dead end: permanent NONE for this position
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    left_count -= 1
                    break
                # mapper.c passes the choose's outpos (0 at top level) as the
                # weight-set position here; only the leaf recursion, whose
                # outpos is the shard position, varies by rep
                item = bucket_choose(
                    in_bucket, x, r,
                    _arg_weights(choose_args, in_bucket, outpos),
                    work,
                )
                itemtype = cmap.item_type(item)
                if itemtype != type_:
                    if item >= 0:
                        # bad item type: permanent NONE for this position
                        # (mapper.c crush_choose_indep semantics)
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left_count -= 1
                        break
                    in_bucket = cmap.buckets[item]
                    continue
                collide = any(out[i] == item for i in range(outpos, endpos))
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(
                            cmap, cmap.buckets[item], weight, x, 1, numrep,
                            0, out2, rep, recurse_tries, 0, False, None, r,
                            choose_args, work,
                        )
                        if out2[rep] == ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and is_out(cmap, weight, item, x):
                    break
                out[rep] = item
                left_count -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] is None:
            out[rep] = ITEM_NONE
        if out2 is not None and out2[rep] is None:
            out2[rep] = ITEM_NONE


def crush_do_rule(
    cmap: CrushMap,
    rule_id: int,
    x: int,
    numrep: int,
    weight: list[int],
    choose_args: dict[int, list[list[int]]] | None = None,
) -> list[int]:
    """mapper.c :: crush_do_rule — interpret the rule's steps for input x.

    weight: per-device reweight vector (16.16), the OSDMap::osd_weight analog.
    choose_args: bucket id -> weight_set rows (crush_choose_arg_map analog);
    position selects the row (clamped), outpos for firstn / rep for indep.
    Returns the raw OSD list (ITEM_NONE holes preserved for indep rules).
    """
    rule = cmap.rules[rule_id]
    t = cmap.tunables
    working: list[int] = []
    result: list[int] = []
    # per-invocation scratch (reference: crush_work) — uniform buckets'
    # permutation cache lives here, shared across the rule's steps
    work: dict = {}
    choose_tries = t.choose_total_tries
    chooseleaf_tries = 0
    for step in rule.steps:
        if step.op == RuleOp.TAKE:
            working = [step.arg1]
        elif step.op == RuleOp.SET_CHOOSE_TRIES:
            choose_tries = step.arg1
        elif step.op == RuleOp.SET_CHOOSELEAF_TRIES:
            chooseleaf_tries = step.arg1
        elif step.op in (
            RuleOp.CHOOSE_FIRSTN,
            RuleOp.CHOOSE_INDEP,
            RuleOp.CHOOSELEAF_FIRSTN,
            RuleOp.CHOOSELEAF_INDEP,
        ):
            recurse = step.op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP)
            firstn = step.op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN)
            want = step.arg1 if step.arg1 > 0 else numrep
            if step.arg1 < 0:
                want = numrep + step.arg1
            out: list[int] = [0] * want
            out2: list[int] = [0] * want if recurse else None
            new_working: list[int] = []
            for wi in working:
                bucket = cmap.buckets[wi]
                if firstn:
                    rt = chooseleaf_tries or choose_tries
                    pos = _choose_firstn(
                        cmap, bucket, weight, x, want, step.arg2, out, 0,
                        choose_tries, rt if recurse else choose_tries,
                        recurse, out2, 0, choose_args, work,
                    )
                    chosen = (out2 if recurse else out)[:pos]
                else:
                    _choose_indep(
                        cmap, bucket, weight, x, want, want, step.arg2, out,
                        0, choose_tries,
                        chooseleaf_tries or 1, recurse, out2, 0, choose_args,
                        work,
                    )
                    chosen = (out2 if recurse else out)[:want]
                new_working.extend(chosen)
            working = new_working
        elif step.op == RuleOp.EMIT:
            result.extend(working)
            working = []
        else:
            raise ValueError(f"unhandled rule op {step.op}")
    return result
