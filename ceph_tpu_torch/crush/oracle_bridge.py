"""ctypes bridge to the C++ CRUSH oracle (native/crush_oracle.cc): the
port's counterpart of ceph_tpu/crush/oracle_bridge.py.

Third bit-exactness implementation and the CPU maps/s baseline for
BASELINE.json config 5 (straw2 10M-object remap), the role mapper.c's
compiled C plays in the reference.  It runs on the host only: the map's
dense arrays are built here in numpy (every bucket algorithm's payload,
the legacy ones included), so no torch device is involved.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from types import SimpleNamespace

import numpy as np

from ..native_oracle import _lib
from .mapper import compile_plan, validate_choose_args
from .types import ITEM_NONE, CrushMap

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")


@lru_cache(maxsize=1)
def _crush_lib() -> ctypes.CDLL:
    lib = _lib()
    lib.cro_do_rule_batch.argtypes = [
        _i32p, _i64p, _i32p, _i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _u32p, ctypes.c_long, _u32p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        _i32p, _i64p, _i64p, ctypes.c_int,  # algs/straws/nodes/max_nodes
        _i32p,  # num_nodes: the true per-bucket tree node counts
        _i32p,
    ]
    lib.cro_do_rule_batch.restype = ctypes.c_int
    lib.cro_do_rule_steps.argtypes = [
        _i32p, _i64p, _i32p, _i32p,
        ctypes.c_int, ctypes.c_int, _i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _u32p, ctypes.c_long, _u32p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        _i32p, _i64p, _i64p, ctypes.c_int,  # algs/straws/nodes/max_nodes
        _i32p,  # num_nodes
        _i32p,
    ]
    lib.cro_do_rule_steps.restype = ctypes.c_int
    lib.cro_hash3.argtypes = [ctypes.c_uint32] * 3
    lib.cro_hash3.restype = ctypes.c_uint32
    lib.cro_hash2.argtypes = [ctypes.c_uint32] * 2
    lib.cro_hash2.restype = ctypes.c_uint32
    lib.cro_ln.argtypes = [ctypes.c_uint32]
    lib.cro_ln.restype = ctypes.c_int64
    lib.cro_ln_table.argtypes = [_i64p]
    lib.cro_ln_table.restype = None
    return lib


def ln_table_full() -> np.ndarray:
    out = np.empty(0x10000, dtype=np.int64)
    _crush_lib().cro_ln_table(out)
    return out


def hash3(a: int, b: int, c: int) -> int:
    return _crush_lib().cro_hash3(a & 0xFFFFFFFF, b & 0xFFFFFFFF, c & 0xFFFFFFFF)


def hash2(a: int, b: int) -> int:
    return _crush_lib().cro_hash2(a & 0xFFFFFFFF, b & 0xFFFFFFFF)


def crush_ln(u: int) -> int:
    return _crush_lib().cro_ln(u)


def dense_map(cmap: CrushMap) -> SimpleNamespace:
    """The map as the oracle's C arrays: [n_idx, max_size] items and
    weights, per-bucket sizes, types and algorithms, straw factors, tree
    node weights and true node counts (the layout of the reference's
    CompiledCrushMap, every bucket algorithm included)."""
    ids = sorted(cmap.buckets)
    n_idx = max((-1 - bid for bid in ids), default=-1) + 1
    rows = max(n_idx, 1)
    max_size = max((b.size for b in cmap.buckets.values()), default=1)
    max_nodes = max([1] + [len(b.node_weights) for b in cmap.buckets.values()
                           if getattr(b, "node_weights", None)])
    d = SimpleNamespace(
        cmap=cmap,
        items=np.full((rows, max_size), ITEM_NONE, dtype=np.int32),
        weights=np.zeros((rows, max_size), dtype=np.int64),
        sizes=np.zeros(rows, dtype=np.int32),
        types=np.zeros(rows, dtype=np.int32),
        algs=np.full(rows, 5, dtype=np.int32),  # straw2
        straws=np.zeros((rows, max_size), dtype=np.int64),
        nodes=np.zeros((rows, max_nodes), dtype=np.int64),
        num_nodes=np.zeros(rows, dtype=np.int32),
        max_nodes=max_nodes,
    )
    for bid, b in cmap.buckets.items():
        i = -1 - bid
        d.items[i, : b.size] = b.items
        d.weights[i, : b.size] = b.weights
        d.sizes[i] = b.size
        d.types[i] = b.type
        d.algs[i] = getattr(b, "alg", 5)
        if getattr(b, "straws", None):
            d.straws[i, : b.size] = b.straws
        if getattr(b, "node_weights", None):
            d.nodes[i, : len(b.node_weights)] = b.node_weights
            d.num_nodes[i] = len(b.node_weights)
    return d


def _choose_args_dense(d: SimpleNamespace, name: str) -> np.ndarray:
    """[positions, n_idx, max_size] int64 weight-set (the batch mapper's
    choose_args_arrays: buckets without an entry keep their own weights,
    short weight_sets clamp to their last row)."""
    ca = validate_choose_args(d.cmap, name)
    P = max((len(ws) for ws in ca.values()), default=1)
    dense = np.broadcast_to(d.weights, (P,) + d.weights.shape).copy()
    for bid, ws in ca.items():
        i = -1 - bid
        size = len(d.cmap.buckets[bid].items)
        for p in range(P):
            dense[p, i, :size] = ws[min(p, len(ws) - 1)]
    return dense


def _marshal(d: SimpleNamespace, xs, weightvec, choose_args: str | None):
    """C-ready inputs; the `cw` entry must stay referenced through the
    ctypes call."""
    m = dict(
        xs=np.ascontiguousarray(np.asarray(xs, dtype=np.int64).astype(np.uint32)),
        wv=np.ascontiguousarray(weightvec, dtype=np.uint32),
        cw=None, positions=0, cw_ptr=None,
    )
    if choose_args is not None:
        cw = np.ascontiguousarray(_choose_args_dense(d, choose_args), dtype=np.int64)
        m.update(cw=cw, positions=cw.shape[0],
                 cw_ptr=cw.ctypes.data_as(ctypes.c_void_p))
    return m


def _pad_to_numrep(out: np.ndarray, numrep: int) -> np.ndarray:
    """crush_do_rule_batch's [N, numrep] contract: NONE tail for a CHOOSE
    with arg1 < 0, truncate any excess."""
    if out.shape[1] < numrep:
        pad = np.full((out.shape[0], numrep - out.shape[1]), ITEM_NONE,
                      dtype=np.int32)
        out = np.concatenate([out, pad], axis=1)
    return out[:, :numrep]


def _map_args(d: SimpleNamespace) -> tuple:
    return (d.items.reshape(-1), d.weights.reshape(-1), d.sizes, d.types,
            d.items.shape[0], d.items.shape[1])


def _legacy_args(d: SimpleNamespace) -> tuple:
    return (d.algs, d.straws.reshape(-1), d.nodes.reshape(-1), d.max_nodes,
            d.num_nodes)


def do_rule_steps_oracle(
    cmap: CrushMap,
    rule_id: int,
    xs,
    numrep: int,
    weightvec,
    choose_args: str | None = None,
    dense: SimpleNamespace | None = None,
) -> np.ndarray:
    """Batched crush_do_rule via the oracle's full step interpreter,
    which speaks multi-choose chains; same contract as
    crush_do_rule_batch."""
    d = dense if dense is not None else dense_map(cmap)
    rule = cmap.rules[rule_id]
    steps = np.ascontiguousarray(
        [[int(s.op), int(s.arg1), int(s.arg2)] for s in rule.steps],
        dtype=np.int32,
    )
    a = _marshal(d, xs, weightvec, choose_args)
    out = np.empty((len(a["xs"]), numrep), dtype=np.int32)
    rc = _crush_lib().cro_do_rule_steps(
        *_map_args(d), steps.reshape(-1), len(rule.steps), numrep,
        cmap.tunables.choose_total_tries, a["xs"], len(a["xs"]), a["wv"],
        len(a["wv"]), a["cw_ptr"], a["positions"], *_legacy_args(d),
        out.reshape(-1),
    )
    if rc != 0:
        raise ValueError(f"cro_do_rule_steps failed rc={rc}")
    return out


def do_rule_batch_oracle(
    cmap: CrushMap,
    rule_id: int,
    xs,
    numrep: int,
    weightvec,
    choose_args: str | None = None,
) -> np.ndarray:
    """Batched crush_do_rule via the C++ oracle; same contract as
    ceph_tpu_torch.crush.mapper.crush_do_rule_batch, on the host."""
    d = dense_map(cmap)
    plan = compile_plan(d, rule_id, numrep)
    if [p["op"] for p in plan] != ["take", "choose", "emit"]:
        # multi-choose chain or EMIT-less rule: the step interpreter
        return do_rule_steps_oracle(cmap, rule_id, xs, numrep, weightvec,
                                    choose_args, dense=d)
    p = dict(plan[0], **plan[1])
    a = _marshal(d, xs, weightvec, choose_args)
    out = np.empty((len(a["xs"]), p["want"]), dtype=np.int32)
    recurse_tries = (
        (p["leaf_tries"] or p["tries"]) if p["firstn"] else (p["leaf_tries"] or 1)
    )
    rc = _crush_lib().cro_do_rule_batch(
        *_map_args(d), p["take"], p["want"], p["type"], int(p["firstn"]),
        int(p["recurse"]), p["tries"], recurse_tries, a["xs"], len(a["xs"]),
        a["wv"], len(a["wv"]), a["cw_ptr"], a["positions"], *_legacy_args(d),
        out.reshape(-1),
    )
    if rc != 0:
        raise ValueError(f"cro_do_rule_batch failed rc={rc}")
    return _pad_to_numrep(out, numrep)
