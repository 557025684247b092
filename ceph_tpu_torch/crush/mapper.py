"""crush_do_rule_batch — the batched CRUSH mapper on a torch device.

The port's counterpart of ceph_tpu/crush/mapper.py.  Reference:
src/crush/mapper.c :: crush_do_rule / crush_choose_firstn /
crush_choose_indep / bucket_straw2_choose, batched over the placement
input x: every batch consumer (balancer, crushtool --test, osdmaptool
--test-map-pgs) is embarrassingly parallel over x.

- The CrushMap is compiled once into dense tensors on one device
  (items/weights/sizes/types padded to the largest bucket):
  ``CompiledCrushMap``.
- A rule compiles into a static step plan (``compile_plan``); the step
  interpreter runs it over [N] lanes, and multi-choose chains (TAKE →
  CHOOSE rack → CHOOSE host → EMIT) flatten the parent axis into the lane
  axis, as mapper.c loops over the working vector.
- Every straw2 draw is K3 (ops/crush_kernels.py) on the card and its
  plain PyTorch version on the CPU; the choose loops are crush/batched.py.

Scope: modern tunables (stable=1, vary_r=1, local retries 0) and straw2
buckets.  A map holding a legacy bucket algorithm (uniform/list/tree/
straw) raises NotImplementedError here; the reference sends those to its
C oracle, which the port does not load yet.  The scalar
``CrushWrapper.do_rule`` serves them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..common.device import resolve_device
from ..common.kernel_telemetry import TELEMETRY
from ..ops import crush_kernels
from .batched import I64Engine, choose_firstn_b, choose_indep_b
from .types import ITEM_NONE, CrushMap, RuleOp

#: bytes of lane state the step interpreter holds per lane of the widest
#: step (x, r, masks, candidates, out and out2 rows, index lists) —
#: generous, so a chunk never runs the device short
_LANE_BYTES = 1024
#: the share of free device memory one chunk may take, and the lane cap
_MEMORY_SHARE = 4
_MAX_CHUNK_LANES = 1 << 24
#: lanes per chunk on the CPU, where the plain straw2 version walks
#: [lanes, S] int64 blocks
_CPU_CHUNK_LANES = 1 << 16


def validate_choose_args(
    cmap: CrushMap, name: str
) -> dict[int, list[list[int]]]:
    """Resolve and sanity-check a named choose_args weight-set: the name
    must exist, every bucket id must be a real (negative) bucket, every
    weight_set must be non-empty with rows matching the bucket size.
    Shared by the scalar and batch entry points so malformed maps (e.g.
    hand-edited text) fail identically everywhere."""
    if name not in cmap.choose_args:
        raise KeyError(
            f"unknown choose_args {name!r}; known: {sorted(cmap.choose_args)}"
        )
    ca = cmap.choose_args[name]
    for bid, ws in ca.items():
        if bid >= 0 or bid not in cmap.buckets:
            raise ValueError(f"choose_args {name!r}: no such bucket {bid}")
        if not ws:
            raise ValueError(
                f"choose_args {name!r}: empty weight_set for bucket {bid}"
            )
        size = len(cmap.buckets[bid].items)
        for row in ws:
            if len(row) != size:
                raise ValueError(
                    f"choose_args {name!r}: weight_set row of {len(row)} "
                    f"for bucket {bid} of size {size}"
                )
    return ca


class CompiledCrushMap:
    """Dense-tensor form of a CrushMap on one device (``cuda`` unless
    given ``device="cpu"``).  ``magic_m`` and ``magic_ka`` are the
    weights' exact magic reciprocals, K3's draw constants
    (``crush_kernels.straw2_magic``), built with the map."""

    def __init__(self, cmap: CrushMap, device=None):
        self.cmap = cmap
        self.device = resolve_device(device)
        ids = sorted(cmap.buckets)
        n_idx = max((-1 - bid for bid in ids), default=-1) + 1
        rows = max(n_idx, 1)
        max_size = max((b.size for b in cmap.buckets.values()), default=1)
        items = np.full((rows, max_size), ITEM_NONE, dtype=np.int32)
        weights = np.zeros((rows, max_size), dtype=np.int64)
        sizes = np.zeros(rows, dtype=np.int32)
        types = np.zeros(rows, dtype=np.int32)
        algs = np.full(rows, 5, dtype=np.int32)  # straw2
        for bid, b in cmap.buckets.items():
            i = -1 - bid
            items[i, : b.size] = b.items
            weights[i, : b.size] = b.weights
            sizes[i] = b.size
            types[i] = b.type
            algs[i] = getattr(b, "alg", 5)
        #: True iff every bucket is straw2 — the batch path covers exactly this
        self.straw2_only = bool((algs == 5).all()) if n_idx else True
        self._np_items = items
        self._np_weights = weights
        self._np_sizes = sizes
        self._np_types = types
        self.items = torch.from_numpy(items).to(self.device)
        self.weights = torch.from_numpy(weights).to(self.device)
        self.sizes = torch.from_numpy(sizes).to(self.device)
        self.types = torch.from_numpy(types).to(self.device)
        self.magic_m, self.magic_ka = (torch.from_numpy(a).to(self.device)
                                       for a in crush_kernels.straw2_magic(weights))
        self.n_idx = n_idx
        self.max_size = max_size
        self._choose_args_cache: dict[str, tuple] = {}

    def choose_args_arrays(self, name: str) -> torch.Tensor:
        """Dense [positions, n_idx, max_size] int64 weights for a named
        choose_args weight-set (reference: crush_choose_arg_map).  Buckets
        without an entry keep their own weights; buckets with fewer
        weight_set rows than the max are clamped to their last row — the
        get_choose_arg_weights position clamp, applied at build time."""
        return self._choose_args(name)[0]

    def choose_args_magic(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """``straw2_magic`` of the weight-set's [positions * n_idx,
        max_size] weights, built with them."""
        return self._choose_args(name)[1]

    def _choose_args(self, name: str):
        cached = self._choose_args_cache.get(name)
        if cached is not None:
            return cached
        ca = validate_choose_args(self.cmap, name)
        P = max((len(ws) for ws in ca.values()), default=1)
        base = self._np_weights
        dense = np.broadcast_to(base, (P,) + base.shape).copy()
        for bid, ws in ca.items():
            i = -1 - bid
            size = len(self.cmap.buckets[bid].items)
            for p in range(P):
                dense[p, i, :size] = ws[min(p, len(ws) - 1)]
        arr = torch.from_numpy(dense).to(self.device)
        magic = tuple(torch.from_numpy(a).to(self.device)
                      for a in crush_kernels.straw2_magic(dense.reshape(-1, dense.shape[-1])))
        self._choose_args_cache[name] = (arr, magic)
        return arr, magic


def compile_plan(cm: CompiledCrushMap, rule_id: int, numrep: int) -> list[dict]:
    """Static step plan for an arbitrary TAKE/(SET_*)/CHOOSE*/EMIT rule
    (the analog of crush_do_rule's step switch)."""
    rule = cm.cmap.rules[rule_id]
    t = cm.cmap.tunables
    plan: list[dict] = []
    tries = t.choose_total_tries
    leaf_tries = 0
    for step in rule.steps:
        if step.op == RuleOp.TAKE:
            plan.append(dict(op="take", take=step.arg1))
        elif step.op == RuleOp.SET_CHOOSE_TRIES:
            tries = step.arg1
        elif step.op == RuleOp.SET_CHOOSELEAF_TRIES:
            leaf_tries = step.arg1
        elif step.op in (
            RuleOp.CHOOSE_FIRSTN,
            RuleOp.CHOOSE_INDEP,
            RuleOp.CHOOSELEAF_FIRSTN,
            RuleOp.CHOOSELEAF_INDEP,
        ):
            want = step.arg1 if step.arg1 > 0 else numrep + step.arg1
            firstn = step.op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN)
            plan.append(
                dict(
                    op="choose",
                    want=want,
                    type=step.arg2,
                    firstn=firstn,
                    recurse=step.op
                    in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP),
                    tries=tries,
                    leaf_tries=leaf_tries,
                )
            )
        elif step.op == RuleOp.EMIT:
            plan.append(dict(op="emit"))
        else:
            raise ValueError(f"unsupported rule op {step.op}")
    if not any(p["op"] == "choose" for p in plan):
        raise ValueError("rule has no CHOOSE step")
    return plan


def _firstn_compact(work: torch.Tensor) -> torch.Tensor:
    """Dense-pack non-NONE entries left, preserving order (crush_do_rule
    concatenates each parent's successes contiguously into the working
    vector)."""
    is_none = (work == ITEM_NONE).to(torch.int8)
    order = torch.argsort(is_none, dim=1, stable=True)
    return torch.gather(work, 1, order)


def _plan_width(plan: list[dict]) -> int:
    """The most lanes per x any step fans out to."""
    width = max_width = 1
    for p in plan:
        if p["op"] == "take":
            width = 1
        elif p["op"] == "choose":
            width *= p["want"]
            max_width = max(max_width, width)
    return max_width


def _run_plan(plan, eng, xs: torch.Tensor, numrep: int) -> torch.Tensor:
    """The step interpreter over [N] lanes: [N, numrep] int32."""
    N, dev = xs.shape[0], xs.device
    work = None          # [N, W] current working vector
    emitted = []         # list of [N, w] blocks
    for p in plan:
        if p["op"] == "take":
            work = torch.full((N, 1), p["take"], dtype=torch.int32, device=dev)
        elif p["op"] == "choose":
            if work is None:
                raise ValueError("CHOOSE before TAKE")
            W = work.shape[1]
            want = p["want"]
            parents = work.reshape(N * W)
            x_b = torch.repeat_interleave(xs, W) if W > 1 else xs
            parent_ok = (parents < 0) & (parents != ITEM_NONE)
            fn_b = choose_firstn_b if p["firstn"] else choose_indep_b
            tries = p["tries"]
            recurse_tries = (
                (p["leaf_tries"] or tries) if p["firstn"] else (p["leaf_tries"] or 1)
            )
            res = fn_b(eng, x_b, parents, want, p["type"],
                       tries, p["recurse"], recurse_tries, parent_ok)
            chosen = res[1] if p["recurse"] else res[0]
            if p["firstn"]:
                cnt = res[2]
                chosen = torch.where(
                    torch.arange(want, device=dev)[None, :] < cnt[:, None],
                    chosen, ITEM_NONE)
            chosen = chosen.reshape(N, W * want)
            if p["firstn"] and W > 1:
                chosen = _firstn_compact(chosen)
            work = chosen
        else:  # emit
            if work is not None:
                emitted.append(work)
            work = None
    # un-emitted working items are DROPPED, like crush_do_rule (the
    # scalar mapper agrees; a rule without EMIT maps to nothing)
    if not emitted:
        return torch.full((N, numrep), ITEM_NONE, dtype=torch.int32, device=dev)
    result = emitted[0] if len(emitted) == 1 else torch.cat(emitted, dim=1)
    # contract: [N, numrep] — truncate extra width, pad scarcity
    if result.shape[1] > numrep:
        result = result[:, :numrep]
    elif result.shape[1] < numrep:
        pad = torch.full((N, numrep - result.shape[1]), ITEM_NONE,
                         dtype=torch.int32, device=dev)
        result = torch.cat([result, pad], dim=1)
    return result.contiguous()


def _chunk_lanes(device: torch.device) -> int:
    """Lanes (x times the widest step) one pass of the interpreter takes."""
    if device.type == "cpu":
        return _CPU_CHUNK_LANES
    free, _ = torch.cuda.mem_get_info(device)
    return max(1 << 16, min(_MAX_CHUNK_LANES, free // _MEMORY_SHARE // _LANE_BYTES))


def batch_chunk(cm: CompiledCrushMap, rule_id: int, numrep: int) -> int:
    """The xs one pass of crush_do_rule_batch's interpreter takes on
    `cm`'s device for this rule: its lane budget over the widest step."""
    return _chunk_xs(cm.device, compile_plan(cm, rule_id, numrep))


def _chunk_xs(device: torch.device, plan: list[dict]) -> int:
    return max(1, _chunk_lanes(device) // _plan_width(plan))


def crush_do_rule_batch(
    cm: CompiledCrushMap,
    rule_id: int,
    xs,
    numrep: int,
    weightvec,
    choose_args: str | None = None,
) -> torch.Tensor:
    """Batched crush_do_rule: xs [N] -> [N, numrep] int32 OSD ids on the
    compiled map's device.

    firstn results are dense with ITEM_NONE tail padding; indep results
    keep positional ITEM_NONE holes (EC shard semantics).  Arbitrary
    TAKE/CHOOSE/EMIT chains are interpreted.  Large batches run in chunks
    of lanes sized by the device's free memory."""
    if not cm.straw2_only:
        raise NotImplementedError(
            "the batch mapper takes straw2 maps only; this map holds legacy "
            "buckets (uniform/list/tree/straw): map it with CrushWrapper.do_rule")
    plan = compile_plan(cm, rule_id, numrep)
    cweights = cmagic = None
    if choose_args is not None:
        cweights = cm.choose_args_arrays(choose_args)
        cmagic = cm.choose_args_magic(choose_args)
    dev = cm.device
    weightvec = torch.as_tensor(np.asarray(weightvec, dtype=np.int64)).to(dev)
    eng = I64Engine(cm, weightvec, cweights, cmagic)
    if isinstance(xs, torch.Tensor):
        xs_t = xs.to(device=dev, dtype=torch.int32)
    else:
        xs_t = torch.from_numpy(np.asarray(xs, dtype=np.int64).astype(np.int32)).to(dev)
    N = xs_t.shape[0]
    chunk_n = _chunk_xs(dev, plan)
    t0 = time.perf_counter()
    if N <= chunk_n:
        out = _run_plan(plan, eng, xs_t, numrep)
    else:
        out = torch.cat([_run_plan(plan, eng, xs_t[lo:lo + chunk_n], numrep)
                         for lo in range(0, N, chunk_n)])
    # dispatch-side wall time, by the device that ran it (K3 on cuda,
    # its plain version on cpu), as the reference records its backend
    TELEMETRY.record("crush_do_rule_batch", dev.type, time.perf_counter() - t0,
                     bytes_in=4 * N, bytes_out=4 * out.numel())
    return out
