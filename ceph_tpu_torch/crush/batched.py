"""Explicitly batched CRUSH choose loops over [B] lanes (reference:
src/crush/mapper.c :: crush_choose_firstn / crush_choose_indep /
bucket_straw2_choose / is_out, batched over x).

The port's counterpart of ceph_tpu/crush/batched.py's int64 engine.  Every
function takes [B]-shaped lane tensors instead of scalars.  The retry
loops are Python loops whose trip count is the maximum over lanes (one
host sync per trip), as ``jax.lax.while_loop`` ran them in the reference.
Every straw2 draw goes to ``ops/crush_kernels.straw2_choose`` (K3 on the
card, its plain version on the CPU).

A lane's result never depends on another lane, so a descent only draws
for the lanes whose result is used (``active``) and, within a descent,
only for the lanes still walking buckets.  The reference draws for every
lane and masks the results; the outputs are the same.

Bit-exactness contract: identical output to reference_mapper.crush_do_rule
and to the reference package's batched mapper for every input.
"""
from __future__ import annotations

import torch

from ..ops import crush_kernels
from .hash import crush_hash32_2
from .types import ITEM_NONE


def _lanes(v, like: torch.Tensor) -> torch.Tensor:
    """`v` (a Python int or a tensor) as a [B] int32 tensor beside `like`."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int32).expand(like.shape).contiguous()
    return torch.full(like.shape, v, dtype=torch.int32, device=like.device)


def straw2_choose_b(cm, bucket_idx, x, r, cweights, position, cmagic=None):
    """bucket_straw2_choose over lanes: bucket_idx/x/r/position are [B];
    returns the chosen item per lane ([B] int32, ITEM_NONE for empty
    buckets).  `cweights` is a choose_args weight-set [P, n_idx, S] or
    None (the map's own weights); `cmagic` is its magic
    (``cm.choose_args_magic``).  The map's own magic goes with its own
    weights."""
    if cweights is None:
        weights, magic = cm.weights, (cm.magic_m, cm.magic_ka)
    else:
        weights, magic = cweights.reshape(-1, cm.items.shape[1]), cmagic
    return crush_kernels.straw2_choose(
        cm.items, weights, cm.sizes, bucket_idx.to(torch.int32),
        x, _lanes(r, x), _lanes(position, x), magic=magic)


def item_type_b(cm, item):
    """Type of each item: devices 0, buckets their declared type."""
    idx = torch.where(item < 0, -1 - item, 0).clamp(0, cm.types.shape[0] - 1)
    return torch.where(item < 0, cm.types[idx.long()], 0)


def is_out_b(weightvec, item, x):
    """mapper.c :: is_out over lanes (probabilistic reweight reject).

    Only device lanes (item >= 0) are tested; the others come back False.
    Every caller reads is_out on device lanes alone, and a retry round
    then hashes only the few devices it drew."""
    out = torch.zeros(item.shape, dtype=torch.bool, device=item.device)
    lanes = torch.nonzero(item >= 0).squeeze(1)
    if lanes.numel() == 0:
        return out
    it = item[lanes]
    n = weightvec.shape[0]
    w = weightvec[it.clamp(max=n - 1).long()]
    h = crush_hash32_2(x[lanes], it) & 0xFFFF
    out[lanes] = (it >= n) | (w == 0) | ((w < 0x10000) & (h >= w))
    return out


class I64Engine:
    """The draw engine: straw2 draws by K3 (int64 crush_ln and div64,
    the divide done on the card by each weight's magic reciprocal), tensor
    row gathers for types and reweights."""

    def __init__(self, cm, weightvec, cweights, cmagic=None):
        self.cm = cm
        self.weightvec = weightvec
        self.cweights = cweights
        self.cmagic = cmagic

    def choose(self, bucket_idx, x, r, position):
        return straw2_choose_b(self.cm, bucket_idx, x, r, self.cweights, position,
                               self.cmagic)

    def item_type(self, item):
        return item_type_b(self.cm, item)

    def is_out(self, item, x):
        return is_out_b(self.weightvec, item, x)


def descend_b(eng, root, x, r, want_type: int, position, active=None):
    """Walk intervening buckets until an item of want_type appears
    (mapper.c's retry_bucket descent), all lanes in lock-step; dead ends
    (empty bucket, device of the wrong type) yield ITEM_NONE.  Lanes
    outside `active` come back ITEM_NONE without a draw."""
    item = _lanes(root, x).clone()  # walked in place below
    if active is not None:
        item = torch.where(active, item, ITEM_NONE)
    r = _lanes(r, x)
    position = _lanes(position, x)
    while True:
        live = (item < 0) & (item != ITEM_NONE)
        go = torch.nonzero(live & (eng.item_type(item) != want_type)).squeeze(1)
        if go.numel() == 0:
            break
        item[go] = eng.choose(-1 - item[go], x[go], r[go], position[go])
    if want_type != 0:
        item = torch.where(item >= 0, ITEM_NONE, item)
    return item


def _any(mask: torch.Tensor) -> bool:
    return bool(mask.any())


def _leaf_firstn_b(eng, x, item, sub_r, outpos, out2, recurse_tries, active):
    """Nested chooseleaf descent over lanes (stable=1: one rep,
    r = sub_r + ftotal, collisions vs out2[:, :outpos])."""
    B, S = out2.shape
    below = torch.arange(S, device=x.device)[None, :] < outpos[:, None]
    leaf0 = torch.full((B,), ITEM_NONE, dtype=torch.int32, device=x.device)
    done = torch.zeros((B,), dtype=torch.bool, device=x.device)
    ftotal = 0
    while ftotal < recurse_tries and _any(active & ~done):
        leaf = descend_b(eng, item, x, sub_r + ftotal, 0, outpos, active & ~done)
        is_dev = leaf >= 0
        collide = ((out2 == leaf[:, None]) & below).any(dim=1) & is_dev
        reject = torch.where(is_dev, eng.is_out(leaf, x), True)
        ok = is_dev & ~collide & ~reject & active
        leaf0 = torch.where(ok & ~done, leaf, leaf0)
        done = done | ok
        ftotal += 1
    return torch.where(done, leaf0, ITEM_NONE), done


def choose_firstn_b(eng, x, root, numrep: int, want_type: int,
                    tries: int, recurse: bool, recurse_tries: int, parent_ok):
    """crush_choose_firstn over lanes.  `root` is [B] (per-lane parent —
    multi-choose steps descend from different buckets per lane);
    `parent_ok` masks lanes whose parent is a real bucket.  Returns
    (out [B, numrep], out2 [B, numrep], count [B])."""
    B, S = x.shape[0], numrep
    dev = x.device
    out = torch.full((B, S), ITEM_NONE, dtype=torch.int32, device=dev)
    out2 = torch.full((B, S), ITEM_NONE, dtype=torch.int32, device=dev)
    outpos = torch.zeros((B,), dtype=torch.int32, device=dev)
    slots = torch.arange(S, device=dev)[None, :]

    for rep in range(numrep):
        item = torch.full((B,), ITEM_NONE, dtype=torch.int32, device=dev)
        leaf = torch.full((B,), ITEM_NONE, dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        ftotal = 0
        while ftotal < tries and _any(parent_ok & ~done):
            active = parent_ok & ~done
            r = rep + ftotal
            cand = descend_b(eng, root, x, r, want_type, outpos, active)
            dead = cand == ITEM_NONE
            collide = ((out == cand[:, None]) & (slots < outpos[:, None])).any(dim=1) & ~dead
            if recurse:
                use_leaf = (cand < 0) & ~dead & ~collide
                leaf_r, leaf_ok_r = _leaf_firstn_b(
                    eng, x, cand, r, outpos, out2, recurse_tries, active & use_leaf)
                direct_ok = (cand >= 0) & ~eng.is_out(cand, x)
                cand_leaf = torch.where(use_leaf, leaf_r, cand)
                reject = ~torch.where(use_leaf, leaf_ok_r, direct_ok)
            else:
                cand_leaf = cand
                reject = dead | torch.where(cand >= 0, eng.is_out(cand, x), False)
            ok = active & ~dead & ~collide & ~reject
            item = torch.where(ok, cand, item)
            leaf = torch.where(ok, cand_leaf, leaf)
            done = done | ok
            ftotal += 1
        put = done[:, None] & (slots == outpos[:, None])
        out = torch.where(put, item[:, None], out)
        out2 = torch.where(put, leaf[:, None], out2)
        outpos = outpos + done.to(torch.int32)
    return out, out2, outpos


def choose_indep_b(eng, x, root, numrep: int, want_type: int,
                   tries: int, recurse: bool, recurse_tries: int, parent_ok):
    """crush_choose_indep over lanes: positional retries
    r = rep + numrep*ftotal; failed positions stay ITEM_NONE (EC shard
    holes).  Returns (out [B, numrep], out2 [B, numrep])."""
    B, S = x.shape[0], numrep
    dev = x.device
    out = torch.full((B, S), ITEM_NONE, dtype=torch.int32, device=dev)
    out2 = torch.full((B, S), ITEM_NONE, dtype=torch.int32, device=dev)
    placed = (~parent_ok)[:, None].expand(B, S).clone()
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    ftotal = 0
    while ftotal < tries and _any(~placed):
        for rep in range(numrep):
            active = parent_ok & ~placed[:, rep]
            r = rep + numrep * ftotal
            # weight-set position is the choose's outpos — 0 at the top
            # level (mapper.c); the leaf recursion below uses rep
            cand = descend_b(eng, root, x, r, want_type, zeros, active)
            dead = cand == ITEM_NONE
            collide = ((out == cand[:, None]) & placed).any(dim=1) & ~dead
            if recurse:
                use_leaf = (cand < 0) & ~dead & ~collide
                need = active & use_leaf
                lleaf = torch.full((B,), ITEM_NONE, dtype=torch.int32, device=dev)
                lok = torch.zeros((B,), dtype=torch.bool, device=dev)
                lf = 0
                while lf < recurse_tries and _any(need & ~lok):
                    got = descend_b(eng, cand, x, rep + numrep * lf + r, 0, rep, need & ~lok)
                    ok_l = (got >= 0) & ~eng.is_out(got, x)
                    lleaf = torch.where(ok_l & ~lok, got, lleaf)
                    lok = lok | ok_l
                    lf += 1
                direct_ok = (cand >= 0) & ~eng.is_out(cand, x)
                cand_leaf = torch.where(use_leaf, torch.where(lok, lleaf, ITEM_NONE), cand)
                ok = ~dead & ~collide & torch.where(use_leaf, lok, direct_ok)
            else:
                cand_leaf = cand
                reject = dead | torch.where(cand >= 0, eng.is_out(cand, x), False)
                ok = ~dead & ~collide & ~reject
            take = active & ok
            # structural dead end: permanent NONE for this position
            # (mapper.c keeps out[rep] = ITEM_NONE and never retries it)
            dead_perm = active & dead
            out[:, rep] = torch.where(take, cand, out[:, rep])
            out2[:, rep] = torch.where(take, cand_leaf, out2[:, rep])
            placed[:, rep] |= take | dead_perm
        ftotal += 1
    return out, out2
