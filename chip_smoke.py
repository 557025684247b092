#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU: the
erasure-code data plane, batched CRUSH placement, the OSD's write and
read batchers, the OSDMap's pool-wide PG mapping, and a cluster of
monitors and OSDs serving librados clients.

    python3 chip_smoke.py            (from the repo root; needs one CUDA card)

It builds the kernels of ceph_tpu_torch/csrc/ with nvcc (one nvcc per
source, all at once) and holds each against its plain PyTorch version.

The erasure-code path (phases 3-9): the GF(2^8) kernels K1 and K2 (K2's
SASS must hold IMMA, the tensor-core instruction of its bitplane
product; K1's row loop is found and counted in the SASS, and each K1 row
logs the tile k1_layout chose and this build's ALU floor beside its
byte bound), then through the entry points a user calls, the RS(8,4) cauchy_good write of
256 objects of 1 MiB (256 MiB resident on the card) in one fused encode,
their degraded read with shards {1, 4, 9, 11} lost, parity
reconstruction, an RS(2,1) 128 MiB encode and decode, a SHEC(6,3,2)
single-chunk decode and a CLAY(8,4,d=11) single-shard repair, every
result compared byte for byte.

The placement path (phases 10-17), on the 1024-OSD map of 128 hosts x 8
OSDs: the crush_ln probe in both forms over 2^25 values; K3 and
ln_scores against their plain versions, and K3's edge cases
(K3_EDGE_CASES: lane counts across its thread choices, narrow and odd
buckets, ties, weights 1 to 0xFFFFFFFF and 0, weight-sets) at every
thread count a lane; then through
CrushWrapper.do_rule_batch, the 10M-object replicated remap before and
after host 17 goes out (minimal movement, no out OSD), an RS(8,4) pool's
indep placement, a balancer weight-set, a 16-rack map with a
multi-choose rule, and crushtool --test on the card against the CPU.
Every placement is checked against the CPU mapper and the scalar mapper.

The OSD path (phases 18-21), RS(8,4) cauchy_good with 256 client
threads on 1 MiB objects as [8, 131072] host stripes: the write batcher
at the option table's defaults with the device pool on and off, one
256-stripe burst in one fused flush (with the flush's stages timed
apart: the pack into pinned staging, the commit to the card, K1, the
fetch), an oversize flush split into device batches through
stream_encode, and the read batcher's degraded read with shards
{1, 4, 9, 11} lost through an in-memory shard store.  Every parity and
read is checked byte for byte, K1's launches must equal the device
batches and decode groups the batchers report, and no op may run
inline.

The OSDMap path (phases 22-24), on the same 1024 OSDs: an OSDMap with a
size-3 replicated pool (rule 0) and an RS(8,4) size-12 pool (rule 1,
chooseleaf indep), their pg_num Ceph's mon_target_pg_per_osd over the
pool's size rounded down to a power of two (32768 and 8192), mapped
through OSDMap.map_pool with no device (cuda) and held equal to
device="cpu" on whole pools and to the scalar pg_to_up_acting_osds on
spread PGs, with one pass timed by stage and the card's idle share
under torch.profiler; then pg_upmap_items on nine PGs and primary
affinity 0 on four hosts (only the upmapped PGs move), then host 17
out (only PGs that held it move, none keeps an out OSD); then
osdmaptool --test-map-pgs --upmap on a map file on cuda and with
--device cpu, which must print the same text.

The cluster path (phases 25-29): a port LocalCluster on the card, 3
monitors and 12 OSDs (one per host, failure domain osd), sized after
`rados bench`'s defaults (4 MiB objects, 16 concurrent ops) with pg_num
64 (mon_target_pg_per_osd 100 x 12 OSDs over pool size 12, rounded down
to a power of two): an RS(8,4) cauchy_good pool on plugin=torch takes
32 writes and reads (every byte, and 8 objects' 12 shards against the
numpy codec; every stripe through the write batcher, none inline); an
OSD holding a data shard is killed and every object read whole and in
a range inside the lost chunk (the read batcher's windowed decode);
that OSD returns empty and the time to clean is the repair latency; a
CLAY(8,4,d=11) pool's 16 objects are rebuilt on another OSD by the
planned repair (d = 11 helpers' repair planes, one K2 apply each); a flipped byte in one
stored shard is found and repaired by a deep scrub.

The mgr (phases 30-32): its PlacementModule and BalancerModule hosted on
a stub mgr whose context is on cuda, over phase 22's map as the mgr
decodes it: the scan's mappings must equal phase 22's, its remap
forecast after phase 23's changes the diff of phase 22's and 23's
mappings, and a dry-run balancer pass's proposals phase 24's
calc_pg_upmaps, each with K3 launched and timed (wall, K3's device time,
the card's idle share under torch.profiler); then a LocalCluster with
the mgr on the card (one monitor, 12 OSDs, the default mgr_modules, an
RS(8,4) pool of pg_num 64 and a size-3 pool of pg_num 128): librados
writes through K1, the prometheus exporter's OSD, placement and
device="cuda..." series, a placement scan on the mgr's own thread with
K3, an active balancer pass whose upmaps commit in a new epoch, and
`ceph -s` from the mgr's digest; last, qa/recovery_smoke.py on cuda with
the failure detector at its default grace, which must exit 0.

For each path the launch counters are set to 0 just before it and read
just after, and every kernel of the path must have launched; K3's draws
on the placement and OSDMap paths must use the magic reciprocals their
compiled maps carry (no build in the wrapper).  K3 is timed over the xs
one pass of the mapper takes, and its bound counts one trip of its slot
loop a slot walked, in the SASS of the library the run built (cuobjdump,
beside nvcc; the kernel must call no subroutine); its group reduction's
trips are logged beside it as overhead; it is timed again at map_pool's launch shapes, the root
and host draws over each pool's seeds.  Every kernel time is the
device's alone (the stream is held until the timed calls are
enqueued); the wrappers' host time a call is logged apart.  The last
lines are the card, one ``kernels`` JSON object (each kernel's time
beside its bound and its plain version's time; K2's also beside its
int8 tensor-core floor, at the CLAY(8,4,d=11) repair and at
CLAY(12,4,d=15)'s wide one), and ``{"ok": true,
"device": {...}}``.  Any failure raises and the exit code is not 0;
without a card, or without the ceph_tpu_torch package beside this
script, it exits 1 and prints no result.

Data is random, made from fixed seeds.  Imports torch, numpy and
ceph_tpu_torch only.
"""
from __future__ import annotations

import collections
import copy
import functools
import io
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SEED = 20261017
#: GPU clock cycles torch.cuda._sleep spins for a millisecond's hold (at
#: the H100's 1980 MHz boost, or longer at a lower clock), and the longest hold
SLEEP_CYCLES_PER_MS = 2_000_000
MAX_HOLD_MS = 3000.0
#: H100 SXM peak HBM bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
OBJECTS = 256
OBJECT_BYTES = 1 << 20
STRIPE_UNIT = 4096
#: H100 SXM dense int8 tensor-core operations/s (NVIDIA data sheet)
INT8_TC_OPS_PER_S = 1.979e15
#: H100 SXM INT32 operations/s: 132 SMs x 64 INT32 lanes (Hopper white
#: paper) at the card's 1980 MHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: integer multiply-adds (IMAD, on the FMA pipe) a second: 64 a clock an
#: SM on compute capability 9.0 (CUDA C++ Programming Guide, throughput
#: table), and instructions a second: four warp schedulers an SM, each
#: issuing one warp instruction (32 threads) a clock
IMAD_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
#: opcodes that issue to the INT32 pipe; IMAD issues to the FMA pipe
INT32_PIPE = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "VIADD", "FLO", "LEA", "IABS", "PRMT"}
#: BASELINE config 5: the remap of 10M objects over a 1024-OSD map
REMAP_OBJECTS = 10_000_000
HOSTS, OSDS_PER_HOST, OUT_HOST = 128, 8, 17
CRUSH_LANES = 1 << 18
PLACEMENT_XS = 1 << 20
CPU_CHECK_XS = 1 << 16
SCALAR_CHECK_XS = 512
SCALAR_CHECK_PGS = 1024
PROBE_ELEMENTS = 1 << 25
#: the cluster phases, after `rados bench`'s defaults (-b 4M, -t 16); 32
#: objects, not 64, since the mgr's phases 30-32 (PERF.md lists the cut)
CLUSTER_OBJECTS = 32
CLUSTER_OBJECT_BYTES = 4 << 20
CLUSTER_THREADS = 16
CLUSTER_CLAY_OBJECTS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rand_bytes(torch, shape, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=g)


def time_ms(torch, fn, iters: int, warmup: int = 2, label: str | None = None
            ) -> tuple[float, float]:
    """(device ms, host ms) of one call: the median over `iters` calls of
    the CUDA events around each call, and of time.perf_counter around it.

    A torch.cuda._sleep ahead of the first event holds the stream until
    the host has enqueued every timed call (twice the last warm-up's host
    time each, and a millisecond), so the events bracket the device's work
    alone and not the wrapper's host work; the host time is on its own
    line when `label` is given."""
    host_s = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    hold_ms = min(2 * iters * host_s * 1e3 + 1.0, MAX_HOLD_MS)
    torch.cuda._sleep(int(hold_ms * SLEEP_CYCLES_PER_MS))
    host = []
    for a, b in ev:
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    dev_ms = float(np.median([a.elapsed_time(b) for a, b in ev]))
    host_ms = float(np.median(host)) * 1e3
    if label:
        log(f"    host time of {label}: {host_ms:.4f} ms per call (device {dev_ms:.4f} ms)")
    return dev_ms, host_ms


def bound_ms(rows: int, n: int, L: int) -> float:
    """Least time (ms) for a [rows, n] apply over L columns: the bytes it
    must move (n*L read, rows*L written) over HBM.  The card has no unit
    that does a GF(2^8) multiply-add as one operation, so there is no
    peak rate to hold the rows*n*L multiply-adds against."""
    return (n + rows) * L / HBM_BYTES_PER_S * 1e3


def tc_floor_ms(rows: int, n: int, L: int) -> float:
    """K2's floor on the tensor cores: its [8*rows, 8*n] x [8*n, L]
    int8 product (2 operations per multiply-add) at the dense int8 peak."""
    return 2 * 64 * rows * n * L / INT8_TC_OPS_PER_S * 1e3


def kernel_entry(name: str, replaces: str, shape: str, err: int, ms: float,
                 plain_ms: float, ops_ms: float, bytes_ms: float,
                 library_ms, card: str, smi: str, **extra) -> dict:
    """One kernel of the placement path for the ``kernels`` line; its
    ``launches`` are filled in from the main path's counts."""
    return {
        "name": name, "route": "cuda", "source": "ceph_tpu_torch/csrc/crush_straw2.cu",
        "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms, "shape": shape, "card": card, "nvidia_smi": smi,
        **extra,
    }


def k3_entry(torch, ck, args, magic, sass: dict, map_bytes: int, err: int, shape: str,
             card: str, smi: str, **extra) -> dict:
    """K3's row of the ``kernels`` line at one launch shape: its device
    and host time (with the map's magic, as the mapper calls it), the
    plain version's, T, and its bound by this build's SASS.  The group
    reduction's operations are kernel overhead, not part of the bound;
    their time is logged beside the row (``reduce_ms``, not printed in
    the line)."""
    lanes, S = args[3].shape[0], args[0].shape[1]
    T = ck.threads_per_lane(lanes, S, ck.sm_count(args[0].device))
    slots = int(args[2][args[3].long().clamp(0, args[0].shape[0] - 1)].clamp(max=S).sum())
    ms, host_ms = time_ms(torch, lambda: ck.straw2_choose(*args, magic=magic), iters=10,
                          label=f"straw2_choose at {shape}")
    plain_ms, _ = time_ms(torch, lambda: ck.straw2_choose_plain(*args), iters=2, warmup=1)
    bytes_ms = (16 * lanes + map_bytes) / HBM_BYTES_PER_S * 1e3
    entry = kernel_entry(
        "crush_straw2_k3", "ceph_tpu/ops/pallas_crush.py:176",
        f"{shape} ({slots} slots walked)", err, ms, plain_ms, k3_bound_ms(sass, slots),
        bytes_ms, None, card, smi, host_ms=host_ms, threads_per_lane=T,
        sass_per_slot=sass["straw2_choose_kernel"],
        sass_per_reduce_trip=sass["straw2_reduce"], **extra)
    return entry, k3_reduce_ms(sass, lanes, T)


def max_err(torch, got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def padded(row: list[int], n: int, none: int) -> list[int]:
    return (row + [none] * n)[:n]


# ---- K3's operation count, from the SASS of the library just built ----


def sass_functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Function name -> [(address, instruction)] of a cuobjdump -sass dump."""
    out: dict[str, list[tuple[int, str]]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]


def branch_target(ins: str) -> int:
    return int(ins.split("0x")[-1].split()[0], 16)


def between(code, lo: int, hi: int) -> list[str]:
    return [ins for addr, ins in code if lo <= addr <= hi]


def innermost_loops(code) -> list[tuple[int, int]]:
    """(head, back edge) of every loop that holds no other loop."""
    loops = [(branch_target(i), a) for a, i in code
             if opcode(i) == "BRA" and branch_target(i) < a]
    return [(h, b) for h, b in loops
            if not any(h <= h2 and b2 < b for h2, b2 in loops if (h2, b2) != (h, b))]


def k3_paths(code) -> tuple[list[str], list[str]]:
    """straw2_choose_kernel's two inner loops: one trip of a thread's
    slot loop (the longest inner loop without SHFL: hash, crush_ln load,
    the magic multiply and shift, the strict minimum) and one trip of its
    group's reduction (the inner loop with SHFL).  The draw has no divide,
    so the kernel must call no subroutine."""
    calls = [i for _, i in code if opcode(i) == "CALL"]
    check(not calls, f"straw2_choose_kernel calls a subroutine: {calls}")
    loops = [between(code, h, b) for h, b in innermost_loops(code)]
    reduce = [ln for ln in loops if any(opcode(i) == "SHFL" for i in ln)]
    slot = max((ln for ln in loops if ln not in reduce), key=len, default=[])
    check(len(reduce) == 1, f"straw2_choose_kernel has {len(reduce)} shuffle loops, want 1")
    check(any(opcode(i) == "LDG" for i in slot), "K3's slot loop holds no load")
    return slot, reduce[0]


def loop_path(code) -> list[str]:
    """One trip of the function's longest loop."""
    head, back = max(((branch_target(i), a) for a, i in code
                      if opcode(i) == "BRA" and branch_target(i) < a),
                     key=lambda t: t[1] - t[0])
    return between(code, head, back)


@functools.lru_cache(maxsize=None)
def library_sass(library: Path) -> dict[str, list[tuple[int, str]]]:
    """The functions of `library`'s SASS (cuobjdump, beside nvcc)."""
    from ceph_tpu_torch.ops.nvcc import nvcc

    sass = subprocess.run([str(Path(nvcc()).parent / "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    return sass_functions(sass)


def path_counts(path: list[str]) -> dict[str, int]:
    """Instructions on the INT32 pipe ("int32"), IMADs on the FMA pipe
    ("imad"), all instructions ("all") and PRMTs ("prmt") of a path."""
    ops = collections.Counter(opcode(i) for i in path)
    return {"int32": sum(n for op, n in ops.items() if op in INT32_PIPE),
            "imad": ops["IMAD"], "all": sum(ops.values()), "prmt": ops["PRMT"]}


def pipe_counts(library: Path) -> dict[str, dict[str, int]]:
    """``path_counts`` per slot K3 walks ("straw2_choose_kernel"), per
    trip of its group reduction ("straw2_reduce") and per element of
    ln_scores, counted in the SASS of `library`."""
    counts = {}
    for name, code in library_sass(library).items():
        if "straw2_choose_kernel" in name:
            paths = dict(zip(("straw2_choose_kernel", "straw2_reduce"), k3_paths(code)))
        elif "ln_scores_kernel" in name:
            paths = {"ln_scores_kernel": loop_path(code)}
        else:
            continue
        for kernel, path in paths.items():
            c = counts[kernel] = path_counts(path)
            log(f"    sass {kernel}: {c['all']} instructions per trip, {c['int32']} on the "
                f"INT32 pipe, {c['imad']} IMAD; "
                f"{dict(collections.Counter(opcode(i) for i in path).most_common())}")
    check(set(counts) == {"straw2_choose_kernel", "straw2_reduce", "ln_scores_kernel"},
          f"K3's kernels not found in the SASS of {library.name}: {sorted(counts)}")
    return counts


def ops_ms(*terms: tuple[int, dict[str, int]]) -> float:
    """Least time (ms) for sum(n x path) over (n, path counts) terms: the
    slowest of the INT32 pipe, the FMA pipe's IMADs and the issue slots."""
    total = {k: sum(n * c[k] for n, c in terms) for k in ("int32", "imad", "all")}
    return max(total["int32"] / INT32_OPS_PER_S, total["imad"] / IMAD_OPS_PER_S,
               total["all"] / ISSUE_PER_S) * 1e3


def k3_bound_ms(counts: dict, slots: int) -> float:
    """K3's operation bound (ms) for a launch that walks `slots` slots: one
    trip of this build's slot loop a slot, which is what a serial strict
    scan of the lane's slots needs."""
    return ops_ms((slots, counts["straw2_choose_kernel"]))


def k3_reduce_ms(counts: dict, lanes: int, T: int) -> float:
    """The least time (ms) of K3's group reduction over `lanes` lanes at T
    threads a lane (log2 T shuffle trips on each of a lane's T threads):
    overhead of the T-thread layout, which the bound does not count."""
    return ops_ms((lanes * T * (T.bit_length() - 1), counts["straw2_reduce"]))


def imma_count(library: Path) -> int:
    """IMMA instructions in gf_apply_k2's SASS in `library` (cuobjdump)."""
    codes = [code for name, code in library_sass(library).items() if "gf_apply_k2" in name]
    check(len(codes) == 1, f"gf_apply_k2 not found once in the SASS of {library.name}")
    ops = collections.Counter(opcode(i) for _, i in codes[0])
    log(f"    sass gf_apply_k2: {sum(ops.values())} instructions, {ops['IMMA']} IMMA; "
        f"{dict(ops.most_common(12))}")
    return ops["IMMA"]


def k1_maxr(rows: int) -> int:
    """The MAXR instantiation of gf_apply_k1 that a matrix of `rows` rows
    launches (csrc gf_apply_k1_launch)."""
    return rows if rows <= 2 else 4 if rows <= 4 else 8 if rows <= 8 else 16


@functools.lru_cache(maxsize=None)
def k1_loop_counts(library: Path) -> dict[int, dict[str, dict[str, int]]]:
    """``path_counts`` of one trip of each of K1's two row loops, per MAXR
    instantiation, in the SASS of `library`: the innermost loops with
    16-byte loads and PRMT (the aligned path).  "trip": the one with more
    PRMT, K1_RING input rows into MAXR output rows over one thread's 16
    byte columns; "tail": the rows left over, one a trip.  Fails if an
    instantiation lacks either, or if the trip does not hold its
    3 x 4 x K1_RING x MAXR lookups."""
    from ceph_tpu_torch.ops.gf_kernels import K1_RING

    counts = {}
    for name, code in library_sass(library).items():
        m = re.search(r"gf_apply_k1ILi(\d+)E", name)
        if not m:
            continue
        maxr = int(m.group(1))
        loops = [between(code, h, b) for h, b in innermost_loops(code)]
        found = sorted((ln for ln in loops if any(opcode(i) == "PRMT" for i in ln)
                        and any(opcode(i) in ("LDG", "LD") and ".128" in i for i in ln)),
                       key=lambda ln: path_counts(ln)["prmt"])
        check(len(found) == 2, f"gf_apply_k1<{maxr}>: {len(found)} loops with 16-byte loads "
                               f"and PRMT, want 2 (the row loop and its tail)")
        tail, trip = (path_counts(ln) for ln in found)
        counts[maxr] = {"trip": trip, "tail": tail}
        check(trip["prmt"] >= 3 * 4 * K1_RING * maxr,
              f"gf_apply_k1<{maxr}>'s row loop holds {trip['prmt']} PRMT, fewer than a "
              f"trip's {3 * 4 * K1_RING * maxr} lookups")
        log(f"    sass gf_apply_k1<{maxr}> row loop: {trip['all']} instructions a trip "
            f"({K1_RING} input rows x 16 byte columns), {trip['int32']} on the INT32 pipe "
            f"({trip['int32'] / 16:.1f} a byte column), {trip['imad']} IMAD, {trip['prmt']} "
            f"PRMT; {dict(collections.Counter(opcode(i) for i in found[1]).most_common(10))}; "
            f"tail {tail['int32']} INT32 a row")
    check(set(counts) == {1, 2, 4, 8, 16}, f"K1's row loops not found in the SASS of "
                                           f"{library.name}: {sorted(counts)}")
    return counts


def k1_note(rows: int, n: int, lens: list[int], dev) -> str:
    """K1's tile at a launch (k1_layout) and its ALU floor in this build:
    n // K1_RING trips of the row loop and n % K1_RING of its tail
    (k1_loop_counts) per 16 byte columns, at the slowest of the INT32
    pipe, IMADs and issue.  The kernel computes all MAXR rows, so the
    count is the build's work at any rows; vectors at a segment's ragged
    end take the unaligned path, which the count does not see."""
    from ceph_tpu_torch.ops import gf_kernels as gk

    lay = gk.k1_layout(max(lens), len(lens), gk.sm_count(dev))
    c = k1_loop_counts(gk.LIBRARY.path())[k1_maxr(rows)]
    trips, tail = divmod(n, gk.K1_RING)
    vectors = sum(-(-L // 16) for L in lens)
    floor = ops_ms((vectors * trips, c["trip"]), (vectors * tail, c["tail"]))
    per_col = (trips * c["trip"]["int32"] + tail * c["tail"]["int32"]) / 16
    return (f"tile {lay.threads} threads x {lay.vecs} x 16 B = {lay.tile_cols} columns, "
            f"{lay.col_tiles * len(lens)} blocks; ALU floor {floor:.4g} ms "
            f"({per_col:.1f} INT32 a byte column in this build)")


#: K3's edge cases, (name, S, n_idx, P, B): B across K3's thread choices
#: at the root's S = 128, narrow and odd S, and choose_args weight-sets of
#: P = 3 rows a bucket; each runs at the host's T and at every T
K3_EDGE_CASES = (
    ("S128 B1", 128, 9, 1, 1), ("S128 B31", 128, 9, 1, 31),
    ("S128 B8192", 128, 9, 1, 8192), ("S128 B32768", 128, 9, 1, 32768),
    ("S1", 1, 9, 1, 4097), ("S8", 8, 9, 1, 4097), ("S37", 37, 9, 1, 4097),
    ("choose_args P3 S8", 8, 9, 3, 3001), ("choose_args P3 S128", 128, 9, 3, 777),
)
#: weights every edge table mixes in, 0 among them
K3_EDGE_WEIGHTS = (1, 1 << 16, 1 << 31, 0xFFFFFFFF, 0)
K3_THREADS = (1, 2, 4, 8, 16, 32)


def k3_edge_case(S: int, n_idx: int, P: int, B: int, seed: int) -> list[np.ndarray]:
    """straw2_choose's arguments (items, weights, sizes, bucket_idx, x, r,
    position) for one edge table of n_idx >= 5 buckets: bucket 0 full,
    bucket 1 with every weight 0, bucket 2 empty, bucket 3 holding one
    item twice at equal weights, bucket 4 all at 0xFFFFFFFF (equal
    quotients of different items are common there), the others ragged;
    weights half from K3_EDGE_WEIGHTS, half random up to 2^32.  Lanes
    take every bucket, and bucket indices and positions past either end
    (the kernel clamps them)."""
    rng = np.random.default_rng(seed)
    none = -0x7FFFFFFE  # ITEM_NONE
    sizes = rng.integers(1, S + 1, n_idx).astype(np.int32)
    sizes[0], sizes[2] = S, 0
    items = np.full((n_idx, S), none, np.int32)
    weights = np.zeros((P * n_idx, S), np.int64)
    edge = np.array(K3_EDGE_WEIGHTS, np.int64)
    for b in range(n_idx):
        n = int(sizes[b])
        items[b, :n] = rng.choice(np.arange(-4096, 4096), n, replace=False)
        for p in range(P):
            row = np.where(rng.random(n) < 0.5, rng.choice(edge, n),
                           rng.integers(1, 1 << 32, n))
            weights[p * n_idx + b, :n] = 0 if b == 1 else 0xFFFFFFFF if b == 4 else row
    if sizes[3] >= 2:
        items[3, 1] = items[3, 0]
        weights[3::n_idx, 1] = weights[3::n_idx, 0] = 1 << 16
    lanes = [rng.integers(-1, n_idx + 1, B), rng.integers(-(1 << 31), 1 << 31, B),
             rng.integers(0, 200, B), rng.integers(-1, P + 2, B)]
    return [items, weights, sizes] + [a.astype(np.int32) for a in lanes]


def k3_edges(torch, dev) -> None:
    """Phase 11's K3 edge cases on the card: every case of K3_EDGE_CASES at
    the host's T and at each T of K3_THREADS, byte-equal to
    straw2_choose_plain."""
    from ceph_tpu_torch.ops import crush_kernels as ck

    sms = ck.sm_count(dev)
    for i, (name, S, n_idx, P, B) in enumerate(K3_EDGE_CASES):
        args = [torch.from_numpy(a).to(dev) for a in k3_edge_case(S, n_idx, P, B, SEED + i)]
        magic = tuple(torch.from_numpy(a).to(dev) for a in ck.straw2_magic(args[1].cpu().numpy()))
        want = ck.straw2_choose_plain(*args)
        host_T = ck.threads_per_lane(B, S, sms)
        for T in (None,) + K3_THREADS:
            got = ck.straw2_choose(*args, magic=magic, threads=T)
            torch.cuda.synchronize()
            err = max_err(torch, got, want)
            check(err == 0, f"K3 edge case {name} at T={T or host_T} differs from the plain "
                            f"version (err {err})")
        log(f"[11 K3 edges] {name} (S {S}, {n_idx} buckets, P {P}, B {B}): host T {host_T}; "
            f"equal to the plain version at T = {host_T} and {K3_THREADS}")


def crush_slice(torch, dev, card: str, smi: str) -> list[dict]:
    """Phases 10-17: the placement path on the card (see the docstring)."""
    from ceph_tpu_torch.crush import (
        ITEM_NONE, CrushWrapper, build_hierarchical_map, make_straw2_bucket)
    from ceph_tpu_torch.crush.mapper import batch_chunk
    from ceph_tpu_torch.crush.types import Rule, RuleOp, RuleStep
    from ceph_tpu_torch.ops import crush_kernels as ck
    from ceph_tpu_torch.tools import crushtool

    entries = []
    sass = pipe_counts(ck.LIBRARY.path())
    g = torch.Generator(device=dev)

    def rand(lo: int, hi: int, n: int, seed: int):
        g.manual_seed(seed)
        return torch.randint(lo, hi, (n,), dtype=torch.int32, device=dev, generator=g)

    # 10. the probe: crush_ln computed (a) or looked up (b), 2^25 values
    u = rand(0, 1 << 16, PROBE_ELEMENTS, SEED + 10)
    plain = ck.crush_ln_stream_plain(u)
    table = ck.ln_tables(dev)[2]
    library = torch.index_select(table, 0, u)
    check(torch.equal(library, plain), "index_select differs from the plain version")
    plain_ms, _ = time_ms(torch, lambda: ck.crush_ln_stream_plain(u), iters=5)
    library_ms, _ = time_ms(torch, lambda: torch.index_select(table, 0, u), iters=20)
    bytes_ms = PROBE_ELEMENTS * 12 / HBM_BYTES_PER_S * 1e3
    probe_ms = {}
    replaces = {"compute": "perf_runs/probe_flat.py:48", "table": "perf_runs/probe_gather.py:33"}
    for f in ck.LN_FORMS:
        got = ck.crush_ln_stream(u, f)
        torch.cuda.synchronize()
        err = max_err(torch, got, plain)
        check(err == 0, f"crush_ln_stream {f} differs from CRUSH_LN_TABLE[u]")
        probe_ms[f], host_ms = time_ms(torch, lambda: ck.crush_ln_stream(u, f), iters=20,
                                       label=f"crush_ln_stream {f}")
        entries.append(kernel_entry(
            f"crush_ln_stream_{f}", replaces[f], f"u [{PROBE_ELEMENTS}] int32", err,
            probe_ms[f], plain_ms, 0.0, bytes_ms, library_ms, card, smi, host_ms=host_ms))
        log(f"[10 probe] crush_ln {f}: bytes equal over {PROBE_ELEMENTS} u, {probe_ms[f]:.4f} ms, "
            f"bound {bytes_ms:.4f} ms by bytes, plain {plain_ms:.3f} ms, "
            f"index_select {library_ms:.4f} ms")
    log(f"[10 probe] faster form: {min(probe_ms, key=probe_ms.get)}; K3 is built with the "
        f"table form")
    del u, plain, library

    # 11. K3 and ln_scores against their plain versions, 2^18 lanes
    w = CrushWrapper(build_hierarchical_map(HOSTS, OSDS_PER_HOST))
    cm = w.compiled(dev)
    x = rand(-(1 << 31), (1 << 31) - 1, CRUSH_LANES, SEED + 11)
    r = rand(0, 50, CRUSH_LANES, SEED + 12)
    items = cm.items[0].expand(CRUSH_LANES, -1).contiguous()  # the root's 128 hosts
    got = ck.ln_scores(x, items, r)
    err = max_err(torch, got, ck.ln_scores_plain(x, items, r))
    check(err == 0, "ln_scores differs from its plain version")
    ms, host_ms = time_ms(torch, lambda: ck.ln_scores(x, items, r), iters=20,
                          label="ln_scores")
    ls_plain_ms, _ = time_ms(torch, lambda: ck.ln_scores_plain(x, items, r), iters=3,
                             warmup=1)
    n = items.numel()
    entries.append(kernel_entry(
        "crush_ln_scores_k3", "ceph_tpu/ops/pallas_crush.py:176",
        f"x, r [{CRUSH_LANES}], items [{CRUSH_LANES}, 128] (the root row)", err, ms,
        ls_plain_ms, ops_ms((n, sass["ln_scores_kernel"])),
        (12 * n + 8 * CRUSH_LANES) / HBM_BYTES_PER_S * 1e3, None, card, smi,
        host_ms=host_ms))
    log(f"[11 K3] ln_scores [{CRUSH_LANES}, 128]: equal to the plain version, {ms:.4f} ms")
    mixed = build_hierarchical_map(HOSTS, OSDS_PER_HOST)
    mixed.buckets[-7].weights[3] = 0  # host5's osd.43 draws S64_MIN
    empty = make_straw2_bucket(mixed, 1, [], [], name="empty")
    mcm = CrushWrapper(mixed).compiled(dev)
    bidx = torch.where(rand(0, 2, CRUSH_LANES, SEED + 13) == 0, 0,
                       rand(1, mcm.n_idx, CRUSH_LANES, SEED + 14)).to(torch.int32)
    zeros = torch.zeros_like(x)
    args = (mcm.items, mcm.weights, mcm.sizes, bidx, x, r, zeros)
    got = ck.straw2_choose(*args)
    err = max_err(torch, got, ck.straw2_choose_plain(*args))
    check(err == 0, "straw2_choose differs from its plain version")
    check(bool((got[bidx == -1 - empty.id] == ITEM_NONE).all()), "an empty bucket chose")
    check(not bool((got == 43).any()), "a zero-weight slot won")
    builds = ck.MAGIC_BUILDS
    check(torch.equal(ck.straw2_choose(*args, magic=(mcm.magic_m, mcm.magic_ka)), got),
          "straw2_choose with the map's magic differs from the call that built it")
    check(ck.MAGIC_BUILDS == builds, "straw2_choose built magic it was given")
    log(f"[11 K3] straw2_choose, {CRUSH_LANES} lanes over the root and {HOSTS} hosts, one "
        f"zero-weight slot, one empty bucket: equal to the plain version, with the magic "
        f"built in the wrapper and with the map's own")
    k3_edges(torch, dev)

    # ---- the placement path: counts set to 0 here, read after phase 16 ----
    ck.reset_launch_counts()
    per_phase = {}

    def k3() -> int:
        return ck.LAUNCHES["crush_straw2_k3"]

    # 12. replicated remap, BASELINE config 5: 10M objects, host 17 out
    k0 = k3()
    weights = np.full(HOSTS * OSDS_PER_HOST, 0x10000, dtype=np.int64)
    xs = torch.arange(REMAP_OBJECTS, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    before = w.do_rule_batch(0, xs, 3, weights)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = w.do_rule_batch(0, xs, 3, weights)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(torch.equal(before, again), "two remaps of the same map differ")
    check(bool(((before != ITEM_NONE).sum(1) == 3).all()), "a mapping holds fewer than 3 OSDs")
    out = torch.arange(OUT_HOST * OSDS_PER_HOST, (OUT_HOST + 1) * OSDS_PER_HOST,
                       dtype=torch.int32, device=dev)
    weights_out = weights.copy()
    weights_out[out.cpu().numpy()] = 0
    t0 = time.perf_counter()
    after = w.do_rule_batch(0, xs, 3, weights_out)
    torch.cuda.synchronize()
    out_s = time.perf_counter() - t0
    check(not bool(torch.isin(after, out).any()), "a mapping holds an out OSD")
    held = torch.isin(before, out).any(1)
    check(torch.equal(before[~held], after[~held]), "a mapping without host 17 moved")
    moved = float((before != after).any(1).float().mean())
    for name, wv, got in (("before", weights, before), ("after", weights_out, after)):
        cpu = w.do_rule_batch(0, np.arange(CPU_CHECK_XS), 3, wv, device="cpu")
        check(torch.equal(cpu, got[:CPU_CHECK_XS].cpu()), f"remap {name}: CPU mapper differs")
        for xv in np.linspace(0, REMAP_OBJECTS - 1, SCALAR_CHECK_XS).astype(np.int64):
            want = padded(w.do_rule(0, int(xv), 3, list(wv)), 3, ITEM_NONE)
            check(got[xv].tolist() == want, f"remap {name}: scalar mapper differs at x={xv}")
    per_phase[12] = k3() - k0
    log(f"[12 remap] {REMAP_OBJECTS} objects x 3 replicas over {HOSTS * OSDS_PER_HOST} "
        f"OSDs: {REMAP_OBJECTS / warm_s:.0f} maps/s ({warm_s:.3f} s; first call "
        f"{cold_s:.3f} s), host {OUT_HOST} out {out_s:.3f} s, {moved:.5f} of objects "
        f"moved, none kept an out OSD, none without host {OUT_HOST} moved; equal to "
        f"the CPU mapper on {CPU_CHECK_XS} and the scalar mapper on {SCALAR_CHECK_XS} "
        f"xs; card {card}, {smi}")
    del again, after

    xs_p = torch.arange(PLACEMENT_XS, dtype=torch.int32, device=dev)
    spot = np.linspace(0, PLACEMENT_XS - 1, SCALAR_CHECK_XS).astype(np.int64)

    def against_scalar(wr, rule: int, nrep: int, got, what: str, choose_args=None) -> None:
        for xv in spot:
            want = padded(wr.do_rule(rule, int(xv), nrep, list(weights), choose_args),
                          nrep, ITEM_NONE)
            check(got[xv].tolist() == want, f"{what}: scalar mapper differs at x={xv}")

    # 13. an RS(8,4) pool: chooseleaf indep host, 12 positions
    k0 = k3()
    t0 = time.perf_counter()
    ec = w.do_rule_batch(1, xs_p, 12, weights)
    torch.cuda.synchronize()
    ec_s = time.perf_counter() - t0
    against_scalar(w, 1, 12, ec, "EC indep")
    per_phase[13] = k3() - k0
    log(f"[13 EC] rule 1 (chooseleaf indep host) x 12 over {PLACEMENT_XS} xs: {ec_s:.3f} s, "
        f"{int((ec == ITEM_NONE).sum())} holes; equal to the scalar mapper on "
        f"{SCALAR_CHECK_XS} xs")

    # 14. a balancer weight-set on the root (crush-compat choose_args)
    k0 = k3()
    wb = copy.deepcopy(w)
    root = wb.map.buckets[-1]
    noise = np.random.default_rng(SEED + 14).uniform(0.8, 1.2, root.size)
    wb.set_choose_args("balancer", -1, [[int(v * e) for v, e in zip(root.weights, noise)]])
    t0 = time.perf_counter()
    bal = wb.do_rule_batch(0, xs_p, 3, weights, choose_args="balancer")
    torch.cuda.synchronize()
    bal_s = time.perf_counter() - t0
    against_scalar(wb, 0, 3, bal, "balancer", "balancer")
    per_phase[14] = k3() - k0
    log(f"[14 balancer] rule 0 with the weight-set over {PLACEMENT_XS} xs: {bal_s:.3f} s, "
        f"{float((bal != before[:PLACEMENT_XS]).any(1).float().mean()):.4f} of objects "
        f"placed apart from the plain map; equal to the scalar mapper")

    # 15. 16 racks: CHOOSE 3 racks, then CHOOSELEAF 1 host in each
    k0 = k3()
    rmap = build_hierarchical_map(HOSTS, OSDS_PER_HOST, racks=16)
    rmap.rules[2] = Rule(rule_id=2, steps=[
        RuleStep(RuleOp.TAKE, -1), RuleStep(RuleOp.CHOOSE_FIRSTN, 3, 2),
        RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 1, 1), RuleStep(RuleOp.EMIT)])
    wr = CrushWrapper(rmap)
    t0 = time.perf_counter()
    rk = wr.do_rule_batch(2, xs_p, 3, weights)
    torch.cuda.synchronize()
    rk_s = time.perf_counter() - t0
    against_scalar(wr, 2, 3, rk, "racks")
    check(not bool((rk == ITEM_NONE).any()), "an object got fewer than 3 racks")
    per_rack = HOSTS // 16 * OSDS_PER_HOST
    racks = torch.sort(rk // per_rack, dim=1).values
    check(bool(((racks[:, 1:] != racks[:, :-1]).all())), "two replicas in one rack")
    per_phase[15] = k3() - k0
    log(f"[15 racks] 16 racks, rule CHOOSE 3 rack / CHOOSELEAF 1 host over {PLACEMENT_XS} xs: "
        f"{rk_s:.3f} s, three racks per object; equal to the scalar mapper")

    # 16. crushtool --test on the card and on the CPU
    k0 = k3()
    mapfile = Path(__file__).resolve().parent / "build" / "chip_smoke" / "map.txt"
    mapfile.parent.mkdir(parents=True, exist_ok=True)
    mapfile.write_text(w.format_text())
    argv = ["-i", str(mapfile), "--test", "--rule", "0", "--num-rep", "3",
            "--max-x", "1023", "--show-utilization", "--show-bad-mappings"]
    texts = []
    for extra in ([], ["--device", "cpu"]):
        buf = io.StringIO()
        check(crushtool.main(argv + extra, out=buf) == 0, f"crushtool {extra} failed")
        texts.append(buf.getvalue())
    check(texts[0] == texts[1], "crushtool --test differs between cuda and cpu")
    check("result size == 3:\t1024/1024" in texts[0], "crushtool found bad mappings")
    per_phase[16] = k3() - k0
    log(f"[16 crushtool] --test --max-x 1023: {len(texts[0].splitlines())} lines, the "
        f"same on cuda and cpu")

    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    log(f"[placement path] launches {launches}; crush_straw2_k3 by phase {per_phase}")
    check(launches["crush_straw2_k3"] > 0, "K3 was not launched on the placement path")
    for phase, count in per_phase.items():
        check(count > 0, f"phase {phase} placed without K3")
    check(ck.MAGIC_BUILDS == 0, f"the placement path built K3's magic {ck.MAGIC_BUILDS} times "
                                f"in the wrapper; the compiled maps carry it")

    # 17. K3 at phase 12's launch shapes: the first root draw and the first
    # host draw of one pass of the interpreter, over the xs it takes
    lanes = min(REMAP_OBJECTS, batch_chunk(cm, 0, 3))
    xs = xs[:lanes]
    zeros = torch.zeros_like(xs)
    root_args = (cm.items, cm.weights, cm.sizes, zeros, xs, zeros, zeros)
    hosts = (-1 - ck.straw2_choose(*root_args)).contiguous()
    host_args = (cm.items, cm.weights, cm.sizes, hosts, xs, zeros, zeros)
    map_bytes = cm.items.numel() * 12 + cm.sizes.numel() * 4
    magic = (cm.magic_m, cm.magic_ka)
    for level, args in (("root", root_args), ("host", host_args)):
        got = ck.straw2_choose(*args)
        err = max_err(torch, got, ck.straw2_choose_plain(*args))
        check(err == 0, f"straw2_choose at the {level} differs from its plain version")
        e, reduce_ms = k3_entry(torch, ck, args, magic, sass, map_bytes, err,
                                f"{lanes} lanes at the {level}", card, smi)
        entries.append(e)
        log(f"[17 K3] {level}, {lanes} lanes, T {e['threads_per_lane']}: {e['ms']:.4f} ms "
            f"(host {e['host_ms']:.4f} ms), bound {e['bound_ms']:.4f} ms by "
            f"{e['bound_by']} (the reduction's overhead {reduce_ms:.4f} ms beyond it), "
            f"plain {e['plain_ms']:.1f} ms")
    for e in entries:
        e["launches"] = launches[e["name"]]
    return entries


# ---- phases 18-21: the OSD's write and read batchers ----


class ShardStore:
    """The read batcher's I/O adapter (the rb_* protocol of
    osd/read_batcher.py) over shards held in memory: OSD j holds shard j
    of every object, OSD 0 is local, the others answer multi-reads in the
    wire's reply shape (base64 payloads), and the OSDs in `down` are out."""

    def __init__(self, pack, down=()):
        self.pack = pack
        self.down = set(down)
        self.shards: dict[tuple[int, str], bytes] = {}  # (osd, oid) -> bytes
        self._lock = threading.Lock()
        self._tid = 0
        self._replies: dict[int, object] = {}

    def rb_local_osd(self):
        return 0

    def rb_is_up(self, osd):
        return osd not in self.down

    def rb_epoch(self):
        return 1

    def rb_reply_timeout(self):
        return 30.0

    def rb_read_local(self, pgid, shard, oid, off, ln):
        b = self.shards.get((0, oid))
        return None if b is None else (b, 1, len(b))

    def rb_send_multiread(self, osd, pgid, shard, reads, epoch):
        rows = []
        for oid, _off, _ln in reads:
            b = self.shards.get((osd, oid))
            rows.append([-2, None, None, None] if b is None else [0, self.pack(b), len(b), 1])
        with self._lock:
            self._tid += 1
            self._replies[self._tid] = type("Reply", (), {"results": rows})
            return self._tid

    def rb_wait_multireads(self, tids, deadline):
        with self._lock:
            return {t: self._replies.pop(t) for t in tids if t in self._replies}


def run_clients(n: int, op) -> tuple[list[float], float]:
    """`op(i)` on n client threads at once: per-op latencies and the wall
    time, in seconds.  Raises the first client's error."""
    lat, errs = [0.0] * n, []

    def go(i: int) -> None:
        t0 = time.perf_counter()
        try:
            op(i)
        except Exception as e:  # raised below, after every client joined
            errs.append(e)
        lat[i] = time.perf_counter() - t0

    ts = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "a client thread hung")
    if errs:
        raise errs[0]
    return lat, wall


def pcts(lat: list[float]) -> str:
    return (f"p50 {np.percentile(lat, 50) * 1e3:.2f} ms, "
            f"p99 {np.percentile(lat, 99) * 1e3:.2f} ms")


def osd_slice(torch, dev, card: str, smi: str, rs84, stripes, objects, si) -> list[dict]:
    """Phases 18-21: RS(8,4) cauchy_good through the OSD's batchers, 256
    client threads, 1 MiB objects as [8, 131072] stripes."""
    from concurrent.futures import ThreadPoolExecutor

    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.common.failpoint import registry
    from ceph_tpu_torch.common.kernel_telemetry import TELEMETRY
    from ceph_tpu_torch.gf.reference_codec import encode_chunks as ref_encode
    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.ops.bitplane import TABLES
    from ceph_tpu_torch.ops.device_pool import POOL
    from ceph_tpu_torch.ops.gf_kernels import apply_matrix_plain
    from ceph_tpu_torch.osd.messages import pack_data
    from ceph_tpu_torch.osd.read_batcher import ReadBatcher, ReadReq
    from ceph_tpu_torch.osd.write_batcher import WriteBatcher

    mat, key = rs84.coding, rs84.bitplane.coding_digest
    xs = list(torch.stack(stripes).cpu().numpy())  # the clients' host stripes
    S = xs[0].shape[1]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        want = list(ex.map(lambda x: ref_encode(mat, x), xs))
    log(f"[18 setup] numpy reference parity of {OBJECTS} stripes: "
        f"{time.perf_counter() - t0:.2f} s")

    def k1() -> int:
        return gf_kernels.LAUNCHES["gf_apply_k1"]

    def same(outs, what: str) -> None:
        for i, (got, ref) in enumerate(zip(outs, want)):
            check(np.array_equal(got, ref), f"{what}: parity of stripe {i} differs "
                  f"from the numpy reference codec")

    # ---- the OSD path: counts set to 0 here, read after phase 21 ----
    gf_kernels.reset_launch_counts()

    # 18. the write batcher at the option table's defaults, pool on and off
    parity = None
    for label, overrides in (("pool on", {}), ("pool off", {"ec_device_pool": False})):
        wb = WriteBatcher(CephContext("osd.0", overrides=overrides), entity="osd.0")
        wb.start()
        out = [None] * OBJECTS
        k0 = k1()
        try:
            lat, wall = run_clients(
                OBJECTS, lambda i: out.__setitem__(i, wb.encode_chunks(mat, xs[i], key)))
        finally:
            wb.stop()
        st = wb.stats()
        same(out, f"phase 18 ({label})")
        check(st["inline"] == 0, f"phase 18 ({label}): {st['inline']} ops encoded inline")
        check(k1() - k0 == st["device_batches"] > 0,
              f"phase 18 ({label}): {k1() - k0} K1 launches for {st['device_batches']} "
              f"device batches")
        parity = parity or out
        log(f"[18 write batcher, {label}] {OBJECTS} clients x 1 MiB: byte-equal, "
            f"{st['flushes']} flushes, {k1() - k0} K1 launches = device batches "
            f"({st['device_batches'] - st['flushes']} from oversize splits), inline 0; "
            f"per op {pcts(lat)}; wall {wall * 1e3:.1f} ms, "
            f"{OBJECTS * OBJECT_BYTES / wall / 2**30:.2f} GiB/s encoded; card {card}, {smi}")

    # 19. one 256-stripe burst in one fused flush
    wb = WriteBatcher(CephContext("osd.0", overrides={
        "ec_batch_window_ms": 10_000.0, "ec_batch_max_stripes": 10_000,
        "ec_batch_max_bytes": 1 << 30}), entity="osd.0")
    wb.start()
    try:
        tickets = [wb.encode_submit(mat, x, key) for x in xs]
        check(wb.queue_depth() == OBJECTS, f"phase 19: {wb.queue_depth()} stripes queued")
        d0, k0 = TELEMETRY.dump(), k1()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wb.flush_now()
        out = [wb.encode_wait(t) for t in tickets]
        flush_s = time.perf_counter() - t0
    finally:
        wb.stop()
    d1, st = TELEMETRY.dump(), wb.stats()
    same(out, "phase 19")
    check((st["flushes"], st["device_batches"], k1() - k0, st["inline"]) == (1, 1, 1, 0),
          f"phase 19: one flush in one launch, got {st} and {k1() - k0} launches")
    flusher_s = d1["ec_batch_flush"]["exec_seconds"] - d0["ec_batch_flush"]["exec_seconds"]
    commit_s = d1["encode_wait"]["exec_seconds"] - d0.get("encode_wait", {}).get(
        "exec_seconds", 0.0)
    log(f"[19 burst] {OBJECTS} stripes in 1 flush, 1 K1 launch, byte-equal: flush_now to "
        f"the last commit {flush_s * 1e3:.1f} ms (the flusher {flusher_s * 1e3:.1f} ms, the "
        f"commit fetch {commit_s * 1e3:.1f} ms)")

    # 20. an oversize flush split through stream_encode: the first flush is
    # held, 96 stripes pile up behind it and flush as one group over the
    # byte cap of 32 stripes (32 MiB), in 3 device batches
    split = 96
    registry().set("osd.write_batcher.flush", "times(1,delay(0.5))")
    wb = WriteBatcher(CephContext("osd.0", overrides={
        "ec_batch_window_ms": 50.0, "ec_batch_max_bytes": 32 * xs[0].nbytes}),
        entity="osd.0")
    wb.start()
    h0, k0 = POOL.stats()["hits"], k1()
    first = {}
    try:
        t = threading.Thread(target=lambda: first.setdefault(0, wb.encode_chunks(mat, xs[0], key)))
        t.start()
        time.sleep(0.2)  # stripe 0 is in the delayed flush; the rest pile up
        tickets = [wb.encode_submit(mat, x, key) for x in xs[1:split + 1]]
        rest = [wb.encode_wait(p) for p in tickets]
        t.join(timeout=60)
    finally:
        wb.stop()
        registry().clear()
    st = wb.stats()
    for i, got in enumerate([first[0]] + rest):
        check(np.array_equal(got, want[i]), f"phase 20: parity of stripe {i} differs")
    batches = 1 + split // 32
    check((st["flushes"], st["device_batches"], k1() - k0) == (2, batches, batches),
          f"phase 20: want 2 flushes and {batches} launches, got {st}, {k1() - k0}")
    hits = POOL.stats()["hits"] - h0
    check(hits > 0, "phase 20: the pool had no hits")
    log(f"[20 oversize] 1 + {split} stripes, device batches of 32: {st['flushes']} flushes, "
        f"{k1() - k0} K1 launches = device batches, {hits} pool hits, byte-equal")

    # 21. the read batcher: degraded read of the 256 objects, shards 1, 4, 9, 11 lost
    lost = (1, 4, 9, 11)
    avail = [j for j in range(12) if j not in lost]
    store = ShardStore(pack_data, down=lost)
    for o in range(OBJECTS):
        full = np.vstack([xs[o], parity[o]])
        for j in avail:
            store.shards[(j, f"obj{o}")] = full[j].tobytes()
    dm, dm_key = rs84.bitplane._decode_entry(tuple(avail))
    rb = ReadBatcher(CephContext("osd.0"), io=store, entity="osd.0")
    rb.start()
    got = [None] * OBJECTS

    def read(o: int) -> None:
        res = rb.gather("1.0", list(range(12)), [ReadReq(j, f"obj{o}") for j in avail],
                        est_bytes=8 * S)
        check(all(res[i] is not None for i in range(8)), f"object {o}: a shard is missing")
        stack = np.stack([np.frombuffer(res[i][0], dtype=np.uint8) for i in range(8)])
        got[o] = rb.decode(dm, stack, dm_key)

    k0 = k1()
    try:
        lat, wall = run_clients(OBJECTS, read)
    finally:
        rb.stop()
    st = rb.stats()
    host_objects = objects.cpu()
    for o in range(OBJECTS):
        back = si.unshard(torch.from_numpy(np.ascontiguousarray(got[o])), OBJECT_BYTES)
        check(torch.equal(back, host_objects[o]), f"phase 21: object {o} reads back wrong")
    check(st["inline"] == 0, f"phase 21: {st['inline']} ops ran inline")
    check(k1() - k0 == st["decode_groups"] > 0,
          f"phase 21: {k1() - k0} K1 launches for {st['decode_groups']} decode groups")
    log(f"[21 read batcher] {OBJECTS} degraded reads of 1 MiB, shards {lost} lost: "
        f"byte-equal, {st['flushes']} flushes, {st['fanouts']} sub-op fan-outs, "
        f"{st['decode_groups']} decode groups = K1 launches; per op {pcts(lat)}; wall "
        f"{wall * 1e3:.1f} ms, {OBJECTS * OBJECT_BYTES / wall / 2**30:.2f} GiB/s read")

    torch.cuda.synchronize()
    launches = k1()
    log(f"[OSD path] launches {dict(gf_kernels.LAUNCHES)}; pool {POOL.stats()}")
    check(launches > 0, "K1 was not launched on the OSD path")

    # K1 at phase 19's launch (one packed [8, 256 x 131072] segment) and the
    # stages of that flush around it: pack, commit, K1, fetch
    pinned = torch.empty((8, OBJECTS * S), dtype=torch.uint8, pin_memory=True)
    pack_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.concatenate(xs, axis=1, out=pinned.numpy())
        pack_ms.append((time.perf_counter() - t0) * 1e3)
    packed = torch.empty((8, OBJECTS * S), dtype=torch.uint8, device=dev)
    h2d_ms, _ = time_ms(torch, lambda: packed.copy_(pinned, non_blocking=True), iters=5,
                        warmup=1)
    tables = TABLES.get(mat, dev, key)
    plain = apply_matrix_plain(mat, packed)
    res = gf_kernels.gf_apply(mat, [packed], tables=tables)
    torch.cuda.synchronize()
    err = max_err(torch, res, plain)
    check(err == 0, "K1 on the packed flush disagrees with the plain version")
    ms, host_ms = time_ms(torch, gf_kernels.prepare(mat, [packed], tables), iters=20,
                          label="K1 at the packed flush (staged launch)")
    plain_ms, _ = time_ms(torch, lambda: apply_matrix_plain(mat, packed), iters=3, warmup=1)
    landing = torch.empty(res.shape, dtype=torch.uint8, pin_memory=True)
    d2h_ms, _ = time_ms(torch, lambda: landing.copy_(res, non_blocking=True), iters=5,
                        warmup=1)
    L = OBJECTS * S
    bound = bound_ms(4, 8, L)
    log(f"[19 breakdown] pack into pinned staging {np.median(pack_ms):.2f} ms (host), "
        f"commit 256 MiB {h2d_ms:.2f} ms, K1 {ms:.4f} ms (bound {bound:.4f} ms by bytes, "
        f"plain {plain_ms:.2f} ms; {k1_note(4, 8, [L], dev)}), fetch 128 MiB "
        f"{d2h_ms:.2f} ms; the batcher's flush {flush_s * 1e3:.1f} ms")
    return [{
        "name": "gf_apply_k1", "route": "cuda", "source": "ceph_tpu_torch/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:184", "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
        "shape": "RS(8,4) write-batcher flush (phase 19): one packed [8, 33554432] segment",
        "flush_ms": flush_s * 1e3, "flusher_ms": flusher_s * 1e3,
        "commit_wait_ms": commit_s * 1e3, "pack_ms": float(np.median(pack_ms)),
        "h2d_ms": h2d_ms, "d2h_ms": d2h_ms, "host_ms": host_ms, "card": card,
        "nvidia_smi": smi,
    }]


# ---- phases 22-24: the OSDMap's pool-wide PG mapping ----


def pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def median_s(torch, fn, n: int = 5) -> float:
    """Median wall seconds of `fn` with the card synchronised after it."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def map_pool_stages(torch, m, pid: int) -> dict:
    """One OSDMap.map_pool pass of pool `pid`, timed whole and by stage
    (medians of 5): the placement-seed hash, CrushWrapper.do_rule_batch to
    a synchronised card, the copy of its result to the host, and the rest
    (the upmap, up-filter and primary post-passes); then one pass under
    torch.profiler for the device's busy time (its kernels' and copies'
    time, one stream) and the calls that wait for the card."""
    from torch.profiler import ProfilerActivity, profile

    pool = m.pools[pid]
    ps = np.arange(pool.pg_num, dtype=np.uint32)
    xs = pool.raw_pg_to_pps_batch(ps).astype(np.int32)

    def rule():
        return m.crush.do_rule_batch(pool.crush_rule, xs, pool.size, m.osd_weight,
                                     device=m.device)

    raw = rule()
    st = {"pps": median_s(torch, lambda: pool.raw_pg_to_pps_batch(ps)),
          "do_rule_batch": median_s(torch, rule),
          "to_host": median_s(torch, lambda: raw.cpu().numpy()),
          "map_pool": median_s(torch, lambda: m.map_pool(pid))}
    st["post"] = st["map_pool"] - st["pps"] - st["do_rule_batch"] - st["to_host"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.map_pool(pid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e6
    st["idle_share"] = 1 - busy / wall
    st["syncs"] = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync"))
    return st


def osdmap_slice(torch, dev, card: str, smi: str):
    """Phases 22-24: OSDMap.map_pool over two pools on the 1024-OSD map,
    then osdmaptool (see the docstring).  Returns the kernels' rows and
    what phase 30 holds the mgr against: the map's maker, phase 22's and
    23's mappings, phase 23's changes, and phase 24's mappings and
    calc_pg_upmaps changes."""
    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.crush import ITEM_NONE, CrushWrapper, build_hierarchical_map
    from ceph_tpu_torch.osd import PG_POOL_ERASURE, OSDMap, calc_pg_upmaps
    from ceph_tpu_torch.ops import crush_kernels as ck
    from ceph_tpu_torch.tools import osdmaptool

    sass = pipe_counts(ck.LIBRARY.path())
    n_osd = HOSTS * OSDS_PER_HOST
    conf = CephContext("mon.a").conf
    target = conf.get("mon_target_pg_per_osd")
    # pool id -> (pg_num, size, rule, type): Ceph's target PGs per OSD over
    # the pool's size, rounded down to a power of two
    pools = {
        1: (pow2_floor(n_osd * target // 3), 3, 0, None),
        2: (pow2_floor(n_osd * target // 12), 12, 1, PG_POOL_ERASURE),
    }
    shards = sum(pg * size for pg, size, _, _ in pools.values())
    check(shards / n_osd <= conf.get("mon_max_pg_per_osd"),
          f"{shards / n_osd} PG shards per OSD, over mon_max_pg_per_osd")
    crush = CrushWrapper(build_hierarchical_map(HOSTS, OSDS_PER_HOST))

    def make(device=None) -> OSDMap:
        m = OSDMap(copy.deepcopy(crush), device=device)
        for pid, (pg_num, size, rule, kind) in pools.items():
            m.create_pool(pid, pg_num=pg_num, size=size, crush_rule=rule,
                          **({"type": kind} if kind else {}))
        return m

    def k3() -> int:
        return ck.LAUNCHES["crush_straw2_k3"]

    def map_all(m: OSDMap) -> tuple[dict, dict, float]:
        """Every pool of `m` mapped once: results, K3 launches per pool,
        wall seconds (card synchronised)."""
        got, per_pool = {}, {}
        t0 = time.perf_counter()
        for pid in pools:
            k0 = k3()
            got[pid] = m.map_pool(pid)
            per_pool[pid] = k3() - k0
        torch.cuda.synchronize()
        return got, per_pool, time.perf_counter() - t0

    def against(m: OSDMap, cpu: OSDMap, got: dict, what: str, n_scalar: int) -> None:
        """`got` (m's map_pool) equals the CPU map's map_pool on whole
        pools and the scalar pg_to_up_acting_osds on `n_scalar` PGs of
        each."""
        for pid, (up, prim) in got.items():
            cup, cprim = cpu.map_pool(pid)
            check(np.array_equal(up, cup) and np.array_equal(prim, cprim),
                  f"{what}: pool {pid} differs from device='cpu'")
            pg_num, size = pools[pid][:2]
            for ps in np.linspace(0, pg_num - 1, n_scalar).astype(np.int64):
                u, p, _, _ = m.pg_to_up_acting_osds(pid, int(ps))
                want = u if pools[pid][3] else padded(u, size, ITEM_NONE)
                check(up[ps].tolist() == want and int(prim[ps]) == p,
                      f"{what}: pool {pid} pg {ps} differs from the scalar mapping")

    # ---- the OSDMap path: counts set to 0 here, read after phase 24 ----
    ck.reset_launch_counts()
    per_phase = {}

    # 22. map_pool of both pools on the card (no device: cuda)
    k0 = k3()
    m = make()
    cpu = make("cpu")
    first, per_pool, cold_s = map_all(m)
    check(m.device.type == "cuda", f"OSDMap mapped on {m.device}, want cuda")
    base, _, warm_s = map_all(m)
    for pid in pools:
        check(all(np.array_equal(a, b) for a, b in zip(first[pid], base[pid])),
              f"two map_pool calls of pool {pid} differ")
    t0 = time.perf_counter()
    against(m, cpu, base, "phase 22", SCALAR_CHECK_PGS)
    check_s = time.perf_counter() - t0
    for pid, (up, _) in base.items():
        pg_num, size, _, kind = pools[pid]
        check(up.shape == (pg_num, size), f"pool {pid}: up shape {up.shape}")
        check(bool((up != ITEM_NONE).all()), f"pool {pid}: a PG has a hole with every OSD in")
    per_phase[22] = k3() - k0
    for pid in pools:
        st = map_pool_stages(torch, m, pid)
        log(f"[22 map_pool] pool {pid} pass {st['map_pool'] * 1e3:.3f} ms (median of 5) = "
            f"pps hash {st['pps'] * 1e3:.3f} + do_rule_batch {st['do_rule_batch'] * 1e3:.3f} + "
            f"to host {st['to_host'] * 1e3:.3f} + post-passes {st['post'] * 1e3:.3f} ms; "
            f"under torch.profiler the card idles {st['idle_share']:.4f} of a pass, "
            f"{st['syncs']} sync and copy calls")
    pool_txt = ", ".join(f"pool {pid} pg_num {pg} size {sz}" for pid, (pg, sz, _, _)
                         in pools.items())
    log(f"[22 map_pool] {pool_txt} over {n_osd} OSDs ({shards / n_osd:.0f} PG shards per "
        f"OSD): cuda {warm_s * 1e3:.1f} ms for both (first call {cold_s * 1e3:.1f} ms), "
        f"K3 launches per pass {per_pool}; equal to device='cpu' on whole pools and the "
        f"scalar mapping on {SCALAR_CHECK_PGS} PGs of each ({check_s:.1f} s); card {card}, "
        f"{smi}")

    # 23. pg_upmap_items and primary affinity 0, then host OUT_HOST out
    k0 = k3()
    out_osds = set(range(OUT_HOST * OSDS_PER_HOST, (OUT_HOST + 1) * OSDS_PER_HOST))
    low_aff = set(range(0, 4 * OSDS_PER_HOST))  # hosts 0-3
    items = {}
    for mm in (m, cpu):
        for o in low_aff:
            mm.set_primary_affinity(o, 0.0)
    up1 = base[1][0]
    # PGs away from host OUT_HOST: eight move their first replica to an OSD
    # of another host, a ninth to an OSD of host OUT_HOST, which goes out below
    away = [ps for ps in range(64) if not out_osds & set(up1[ps].tolist())][:9]
    for ps in away[:8]:
        hosts = {o // OSDS_PER_HOST for o in up1[ps].tolist()}
        to = next(o for o in range(n_osd) if o // OSDS_PER_HOST not in hosts | {OUT_HOST})
        items[(1, ps)] = [(int(up1[ps][0]), to)]
    items[(1, away[8])] = [(int(up1[away[8]][0]), min(out_osds))]
    for mm in (m, cpu):
        mm.pg_upmap_items.update(items)
    t0 = time.perf_counter()
    mid, _, mid_s = map_all(m)
    for pid, (up, prim) in mid.items():
        bup, bprim = base[pid]
        moved = ~(up == bup).all(1)
        check(set(np.nonzero(moved)[0].tolist()) == {ps for p, ps in items if p == pid},
              f"pool {pid}: the upmap items moved other PGs")
        turned = prim != bprim
        check(all(int(p) in low_aff for p in bprim[turned & ~moved]),
              f"pool {pid}: a primary moved off an OSD with full affinity")
        check(not any(int(p) in low_aff for p in prim[turned & ~moved]),
              f"pool {pid}: a primary moved onto an OSD with affinity 0")
    for mm in (m, cpu):
        for o in out_osds:
            mm.mark_out(o)
    after, _, out_s = map_all(m)
    against(m, cpu, after, "phase 23", SCALAR_CHECK_PGS // 4)
    n_moved = {}
    for pid, (up, prim) in after.items():
        mup, mprim = mid[pid]
        check(not bool(np.isin(up, list(out_osds)).any()), f"pool {pid}: an up set holds an out OSD")
        held = np.isin(mup, list(out_osds)).any(1)
        moved = ~(up == mup).all(1) | (prim != mprim)
        check(not bool((moved & ~held).any()), f"pool {pid}: a PG without host {OUT_HOST} moved")
        check(not bool(((up == ITEM_NONE).any(1)).any()), f"pool {pid}: a PG lost a shard")
        n_moved[pid] = f"{int(moved.sum())}/{len(up)}"
    per_phase[23] = k3() - k0
    log(f"[23 remap] {len(items)} pg_upmap_items on pool 1 and affinity 0 on "
        f"{len(low_aff)} OSDs: {mid_s * 1e3:.1f} ms, only the upmapped PGs moved; host "
        f"{OUT_HOST} out: {out_s * 1e3:.1f} ms, PGs moved {n_moved}, all of them held host "
        f"{OUT_HOST}, none holds an out OSD; equal to device='cpu' and the scalar mapping "
        f"on {SCALAR_CHECK_PGS // 4} PGs of each; "
        f"card {card}, {smi}")

    # 24. osdmaptool --test-map-pgs and --upmap on a map file, cuda and cpu
    k0 = k3()
    fresh = make()
    mappings = {pid: fresh.map_pool(pid) for pid in pools}
    t0 = time.perf_counter()
    upmaps = calc_pg_upmaps(fresh, max_deviation=1, max_iterations=100, mappings=mappings)
    n_upmaps = len(upmaps)
    upmap_s = time.perf_counter() - t0
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    blob = json.dumps(make().to_json())
    texts, secs = [], []
    for extra in ([], ["--device", "cpu"]):
        mapfile = workdir / f"osdmap_{extra[-1] if extra else 'cuda'}.json"
        mapfile.write_text(blob)  # --upmap writes the balanced map back
        argv = [str(mapfile), "--test-map-pgs", "--upmap", "-", "--upmap-deviation", "1",
                "--upmap-max", "100", *extra]
        buf = io.StringIO()
        t0 = time.perf_counter()
        check(osdmaptool.main(argv, out=buf) == 0, f"osdmaptool {extra} failed")
        secs.append(time.perf_counter() - t0)
        texts.append(buf.getvalue())
    check(texts[0] == texts[1], "osdmaptool differs between cuda and cpu")
    lines = texts[0].splitlines()
    check(sum(ln.startswith("osd.") for ln in lines) == n_osd, "a --test-map-pgs row is missing")
    changes = sum(ln.startswith("ceph osd pg-upmap-items") for ln in lines)
    check(changes > 0, "--upmap proposed no change")
    per_phase[24] = k3() - k0
    log(f"[24 osdmaptool] --test-map-pgs --upmap - --upmap-deviation 1 --upmap-max 100: "
        f"{len(lines)} lines, {changes} pg-upmap-items commands, "
        f"{[ln for ln in lines if ln.startswith('# score')][0]}; the same on cuda "
        f"({secs[0]:.2f} s) and cpu ({secs[1]:.2f} s); calc_pg_upmaps alone over "
        f"precomputed mappings: {upmap_s:.3f} s on the host, {n_upmaps} changes; card "
        f"{card}, {smi}")

    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    log(f"[OSDMap path] launches {launches}; crush_straw2_k3 by phase {per_phase}")
    for phase, count in per_phase.items():
        check(count > 0, f"phase {phase} mapped without K3")
    check(ck.MAGIC_BUILDS == 0, f"the OSDMap path built K3's magic {ck.MAGIC_BUILDS} times "
                                f"in the wrapper; the compiled maps carry it")

    # K3 at map_pool's launch shapes: the root and the host draw over each
    # pool's placement seeds (one pass of the interpreter takes the pool)
    entries = map_pool_k3_rows(torch, dev, ck, sass, m, "24", "OSDMap.map_pool",
                               {pid: f"{per_pool[pid]} K3 launches per map_pool"
                                for pid in pools}, card, smi)
    for e, pid in zip(entries, [p for p in pools for _ in range(2)]):
        e["launches"] = launches[e["name"]]
        e["launches_per_pass"] = per_pool[pid]
    return entries, SimpleNamespace(
        make=make, pools=pools, base=base, after=after, items=items, low_aff=low_aff,
        out_osds=out_osds, mappings24=mappings, upmaps24=upmaps, sass=sass)


def map_pool_k3_rows(torch, dev, ck, sass: dict, m, phase: str, route: str,
                     notes: dict, card: str, smi: str) -> list[dict]:
    """K3's rows at map_pool's launch shapes on map `m`: the root and the
    host draw over each pool's placement seeds, each held against the
    plain version and timed (``launches`` is left to the caller)."""
    entries = []
    cm = m.crush.compiled(dev)
    map_bytes = cm.items.numel() * 12 + cm.sizes.numel() * 4
    magic = (cm.magic_m, cm.magic_ka)
    for pid, pool in sorted(m.pools.items()):
        pg_num, size, rule = pool.pg_num, pool.size, pool.crush_rule
        pps = torch.from_numpy(
            pool.raw_pg_to_pps_batch(np.arange(pg_num)).astype(np.int32)).to(dev)
        zeros = torch.zeros_like(pps)
        root_args = (cm.items, cm.weights, cm.sizes, zeros, pps, zeros, zeros)
        hosts = (-1 - ck.straw2_choose(*root_args)).contiguous()
        host_args = (cm.items, cm.weights, cm.sizes, hosts, pps, zeros, zeros)
        for level, args in (("root", root_args), ("host", host_args)):
            got = ck.straw2_choose(*args)
            err = max_err(torch, got, ck.straw2_choose_plain(*args))
            check(err == 0, f"straw2_choose at pool {pid}'s {level} draw differs")
            e, reduce_ms = k3_entry(
                torch, ck, args, magic, sass, map_bytes, err,
                f"{route}, pool {pid} (pg_num {pg_num}, size {size}, rule {rule}): "
                f"{pg_num} lanes at the {level}", card, smi)
            entries.append(e)
            log(f"[{phase} K3] {route} pool {pid}, {pg_num} lanes at the {level}, T "
                f"{e['threads_per_lane']}: {e['ms']:.4f} ms (host {e['host_ms']:.4f} ms), "
                f"bound {e['bound_ms']:.4f} ms (the reduction's overhead {reduce_ms:.4f} ms "
                f"beyond it), plain {e['plain_ms']:.2f} ms, {notes[pid]}")
    return entries


# ---- phases 25-29: the cluster (monitors, OSDs, librados) on the card ----


def run_ops(n_ops: int, threads: int, op) -> tuple[list[float], float]:
    """`op(i)` for i < n_ops on `threads` client threads: per-op latencies
    and the wall time, in seconds.  Raises the first op's error."""
    from concurrent.futures import ThreadPoolExecutor

    lat = [0.0] * n_ops

    def go(i: int) -> None:
        t0 = time.perf_counter()
        op(i)
        lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        for f in [ex.submit(go, i) for i in range(n_ops)]:
            f.result(timeout=600)
    return lat, time.perf_counter() - t0


def rate(lat: list[float], wall: float, nbytes: int) -> str:
    return (f"wall {wall:.2f} s, per op {pcts(lat)}, "
            f"{nbytes / wall / 2**30:.3f} GiB/s")


def wait_peered(c, pid: int, pg_num: int) -> float:
    """Seconds until the primary of every PG of a new pool has peered
    (ops before that are refused with EAGAIN and retried)."""
    t0 = time.perf_counter()
    placed = (None, [])
    while True:
        m_ = c._leader().osdmon.osdmap
        if placed[0] is not m_:  # one map's primaries, computed once
            placed = (m_, [m_.pg_to_up_acting_osds(pid, ps)[3] for ps in range(pg_num)])
        waiting = 0
        for ps, primary in enumerate(placed[1]):
            pg = c.osds[primary].pgs.get(f"{pid}.{ps}")
            waiting += pg is None or pg.activated_interval != pg.interval_start
        if not waiting:
            return time.perf_counter() - t0
        check(time.perf_counter() - t0 < 600, f"{waiting} PGs of pool {pid} never peered")
        time.sleep(0.5)


def cluster_slice(torch, dev, card: str, smi: str) -> list[dict]:
    """Phases 25-29: a port LocalCluster on the card (3 monitors, 12 OSDs
    one per host, failure domain osd), sized after `rados bench`'s
    defaults: 4 MiB objects, 16 concurrent ops, pg_num 64 (Ceph's
    mon_target_pg_per_osd 100 x 12 OSDs / pool size 12, rounded down to
    a power of two)."""
    from ceph_tpu_torch.common.kernel_telemetry import TELEMETRY
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.gf.reference_codec import encode_chunks as ref_encode
    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.ops.bitplane import TABLES
    from ceph_tpu_torch.ops.gf_kernels import apply_matrix_plain, gf_apply
    from ceph_tpu_torch.osd.osdmap import object_ps
    from ceph_tpu_torch.qa import LocalCluster
    from ceph_tpu_torch.store.object_store import Transaction

    k, m, d = 8, 4, 11
    n_osds, pg_num = 12, 64
    n_obj, obj_bytes, threads = CLUSTER_OBJECTS, CLUSTER_OBJECT_BYTES, CLUSTER_THREADS
    n_clay = CLUSTER_CLAY_OBJECTS
    rng = np.random.default_rng(SEED + 25)
    objs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8).tobytes() for _ in range(n_obj)]
    oid = [f"bench_{i}" for i in range(n_obj)]

    def launches() -> dict:
        torch.cuda.synchronize()
        return dict(gf_kernels.LAUNCHES)

    def rows(pool_name: str) -> dict:
        agg = dict.fromkeys(("repairs", "helper_reads", "bytes_read", "bytes_repaired",
                             "full_gathers"), 0)
        for osd in c.osds.values():
            for row in osd.recovery_acct.dump()["per_pool"]["rows"]:
                if row["labels"]["pool"] == str(pids[pool_name]):
                    for f in agg:
                        agg[f] += row[f]
        return agg

    def stats(attr: str) -> dict:
        out: dict = {}
        for osd in c.osds.values():
            for f, v in getattr(osd, attr).stats().items():
                out[f] = out.get(f, 0) + v
        return out

    def victim_shards(victim: int, pid: int) -> dict:
        st = c.osds[victim].store
        return {(cid, o): bytes(st.read(cid, o)) for cid in st.list_collections()
                if cid.startswith(f"{pid}.") for o in st.list_objects(cid)
                if not o.startswith("_")}

    def wait_active(name: str) -> float:
        return wait_peered(c, pids[name], pg_num)

    def wipe_and_revive(victim: int) -> float:
        """The victim comes back with an empty store (a replaced disk);
        seconds until every PG of both pools is clean again."""
        c.kill_osd(victim)
        c._stores.pop(victim)
        t0 = time.perf_counter()
        c.revive_osd(victim)
        for name in pids:
            c.wait_clean(name, timeout=600)
        return time.perf_counter() - t0

    # A killed OSD is noticed by the primaries alone: a sub-op to it
    # times out after 1.5 s.  The monitor's failure detector is held off
    # (heartbeat grace 600 s) so that phase 26's degraded reads meet no
    # down-marking mid-phase and these phases stay comparable with the
    # runs before the OSD's re-boot on a wrong down-marking (phase 32
    # runs a cluster at the default grace).  The repair planner
    # plans on every live helper: its cost-aware pruning (on by default)
    # drops helpers whose queues the clients deepened, and a CLAY plan on
    # fewer than d helpers falls back to reading k whole chunks.
    conf = {"osd_subop_reply_timeout": 1.5, "osd_heartbeat_grace": 600.0,
            "osd_repair_cost_aware": False}
    c = LocalCluster(n_mons=3, n_osds=n_osds, conf_overrides=conf)  # device: cuda
    t0 = time.perf_counter()
    c.start()
    log(f"[25 start] 3 mons in one quorum (election epoch "
        f"{c._leader().elector.epoch}) and {n_osds} OSDs up in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        check(all(o.device.type == "cuda" for o in c.osds.values()), "an OSD is not on cuda")
        # every inline (non-batched) encode the OSDs record: none may run
        # on the RS(8,4) pool, whose writes belong to the write batcher
        inline = []
        for osd in c.osds.values():
            def staged(stage, t0, t1, span=None, _f=osd._op_stage, **tags):
                if tags.get("codec_inline"):
                    inline.append(stage)
                return _f(stage, t0, t1, span, **tags)
            osd._op_stage = staged
        c.create_ec_pool("rs84", k=k, m=m, pg_num=pg_num, plugin="torch",
                         extra_profile={"technique": "cauchy_good"})
        client = c.client()
        io = client.open_ioctx("rs84")
        pids = {"rs84": client.pool_id("rs84")}
        peer_s = {"rs84": wait_active("rs84")}
        codec = ErasureCodePluginRegistry.instance().factory(
            {"plugin": "numpy", "technique": "cauchy_good", "k": str(k), "m": str(m)})
        L = codec.get_chunk_size(obj_bytes)

        # ---- the cluster path: counts set to 0 here, read after phase 29 ----
        gf_kernels.reset_launch_counts()
        per_phase = {}

        # 25. write 32 x 4 MiB from 16 client threads, then read them back
        l0, wb0 = launches(), stats("write_batcher")
        w_lat, w_wall = run_ops(n_obj, threads, lambda i: io.write_full(oid[i], objs[i]))
        back = [None] * n_obj
        r_lat, r_wall = run_ops(n_obj, threads, lambda i: back.__setitem__(i, io.read(oid[i])))
        for i in range(n_obj):
            check(back[i] == objs[i], f"phase 25: {oid[i]} reads back wrong")
        m_ = c._leader().osdmon.osdmap
        for i in range(8):
            ps = object_ps(oid[i], pg_num)
            _u, _up, acting, _p = m_.pg_to_up_acting_osds(pids["rs84"], ps)
            data = np.zeros(k * L, np.uint8)
            data[:obj_bytes] = np.frombuffer(objs[i], np.uint8)
            full = np.vstack([data.reshape(k, L), ref_encode(codec.coding, data.reshape(k, L))])
            for j, o in enumerate(acting):
                if o < 0:
                    continue  # a slot CRUSH left empty (see phase 28)
                got = bytes(c.osds[o].store.read(f"{pids['rs84']}.{ps}s{j}", oid[i]))
                check(got == full[j].tobytes(),
                      f"phase 25: {oid[i]} shard {j} on osd.{o} differs from the numpy codec")
        wb, l1 = stats("write_batcher"), launches()
        per_phase[25] = {n: l1[n] - l0[n] for n in l1}
        check(per_phase[25]["gf_apply_k1"] > 0, "phase 25: K1 was not launched")
        check(wb["flushes"] > wb0.get("flushes", 0), "phase 25: no write-batcher flush")
        check(wb["stripes"] - wb0.get("stripes", 0) == n_obj,
              f"phase 25: {wb['stripes'] - wb0.get('stripes', 0)} stripes batched for "
              f"{n_obj} writes")
        check(not inline, f"phase 25: {len(inline)} encodes ran inline in the codec")
        stages = {}
        for osd in c.osds.values():
            dump = osd.cct.perf.dump()["osd"]
            for st in ("stage_admission", "stage_queue", "stage_encode", "stage_subop",
                       "stage_commit", "stage_read_gather", "stage_read_decode"):
                h = dump.get(st) or {}
                cnt, tot = stages.get(st, (0, 0.0))
                stages[st] = (cnt + h.get("count", 0), tot + h.get("sum", 0.0))
        log(f"[25 RS(8,4) cluster] {n_obj} x {obj_bytes >> 20} MiB from {threads} threads, "
            f"pg_num {pg_num} (every PG peered {peer_s['rs84']:.1f} s after the pool was "
            f"created): every byte and 8 objects' 12 shards equal the numpy codec; "
            f"{wb['flushes'] - wb0.get('flushes', 0)} write-batcher flushes, "
            f"K1 {per_phase[25]['gf_apply_k1']} launches, inline 0; write "
            f"{rate(w_lat, w_wall, n_obj * obj_bytes)}; read {rate(r_lat, r_wall, n_obj * obj_bytes)}")
        log("[25 stages] per op, mean ms over the OSDs' histograms: " + ", ".join(
            f"{st[6:]} {tot / cnt * 1e3:.2f} (x{cnt})" for st, (cnt, tot) in stages.items() if cnt))

        # 26. kill an OSD holding a data shard; full and ranged degraded reads
        ps0 = object_ps(oid[0], pg_num)
        _u, _up, acting0, primary0 = m_.pg_to_up_acting_osds(pids["rs84"], ps0)
        victim = next(acting0[j] for j in range(k) if acting0[j] >= 0 and acting0[j] != primary0)
        shard_of = {}
        for i in range(n_obj):
            _u, _up, acting, _p = m_.pg_to_up_acting_osds(pids["rs84"], object_ps(oid[i], pg_num))
            # a PG with the victim's slot left empty needs no decode
            shard_of[i] = acting.index(victim) if victim in acting else k
        before = victim_shards(victim, pids["rs84"])
        l0, rb0 = launches(), stats("read_batcher")
        c.kill_osd(victim)
        window = min(64 << 10, L // 2)  # inside one chunk, past its first 4 KiB
        full_lat, full_wall = run_ops(n_obj, threads, lambda i: back.__setitem__(i, io.read(oid[i])))
        for i in range(n_obj):
            check(back[i] == objs[i], f"phase 26: degraded read of {oid[i]} is wrong")
        dec0 = TELEMETRY.dump().get("read_batch_decode", {}).get("bytes_in", 0)

        def ranged(i: int) -> None:
            off = (shard_of[i] % k) * L + 4096
            back[i] = (off, io.read(oid[i], off=off, length=window))

        rg_lat, rg_wall = run_ops(n_obj, threads, ranged)
        for i in range(n_obj):
            off, got = back[i]
            check(got == objs[i][off:off + window], f"phase 26: ranged read of {oid[i]} is wrong")
        decoded = TELEMETRY.dump().get("read_batch_decode", {}).get("bytes_in", 0) - dec0
        need = sum(1 for i in range(n_obj) if shard_of[i] < k)
        rb, l1 = stats("read_batcher"), launches()
        per_phase[26] = {n: l1[n] - l0[n] for n in l1}
        check(rb["decode_groups"] > rb0.get("decode_groups", 0), "phase 26: no decode group")
        check(decoded == need * k * window,
              f"phase 26: the ranged decodes took {decoded} bytes, want {need} x {k} x {window}")
        check(per_phase[26]["gf_apply_k1"] + per_phase[26]["gf_apply_k2"] > 0,
              "phase 26: no K1 or K2 launch")
        log(f"[26 degraded] osd.{victim} down ({need} of {n_obj} objects lost a data shard): "
            f"full reads {rate(full_lat, full_wall, n_obj * obj_bytes)}; ranged {window >> 10} KiB "
            f"reads inside the lost chunk {rate(rg_lat, rg_wall, n_obj * window)}; "
            f"{rb['decode_groups'] - rb0.get('decode_groups', 0)} read-batcher decode groups, "
            f"launches {per_phase[26]}")

        # 27. the victim returns empty: repair latency to clean
        l0, a0 = launches(), rows("rs84")
        c._stores.pop(victim)
        t0 = time.perf_counter()
        c.revive_osd(victim)
        c.wait_clean("rs84", timeout=600)
        repair_s = time.perf_counter() - t0
        after = victim_shards(victim, pids["rs84"])
        check(after == before, f"phase 27: osd.{victim}'s rebuilt shards differ "
              f"({len(after)} against {len(before)})")
        a1, l1 = rows("rs84"), launches()
        per_phase[27] = {n: l1[n] - l0[n] for n in l1}
        rebuilt = sum(len(b) for b in after.values())
        log(f"[27 repair] osd.{victim} back empty, clean in {repair_s:.2f} s: {len(after)} "
            f"shards, {rebuilt / 2**20:.1f} MiB rebuilt ({rebuilt / repair_s / 2**30:.3f} GiB/s), "
            f"{a1['repairs'] - a0['repairs']} rebuilds reading "
            f"{(a1['bytes_read'] - a0['bytes_read']) / 2**20:.1f} MiB, launches {per_phase[27]}")

        # 28. CLAY(8,4,d=11): 16 x 4 MiB, an OSD back empty, planned repair
        c.create_ec_pool("clay84", k=k, m=m, pg_num=pg_num, plugin="clay",
                         extra_profile={"d": str(d)})
        cio = client.open_ioctx("clay84")
        pids["clay84"] = client.pool_id("clay84")
        peer_s["clay84"] = wait_active("clay84")
        # CRUSH's indep retries can leave a slot of a 12-wide PG empty on
        # exactly 12 OSDs; a lost shard there has 10 helpers, fewer than
        # d, and CLAY reads k whole chunks instead.  The objects go to
        # PGs whose 12 slots are all placed.
        m_ = c._leader().osdmon.osdmap
        full_pgs = [ps for ps in range(pg_num)
                    if min(m_.pg_to_up_acting_osds(pids["clay84"], ps)[2]) >= 0]
        coid = [o for o in (f"clay_{j}" for j in range(64 * n_clay))
                if object_ps(o, pg_num) in full_pgs][:n_clay]
        check(len(coid) == n_clay, "too few CLAY object names land in complete PGs")
        cw_lat, cw_wall = run_ops(n_clay, threads, lambda i: cio.write_full(coid[i], objs[i]))
        # the victim is no primary of these objects' PGs: a primary that
        # lost its own shard rebuilds it by the broad gather, by design
        # (recovery.py, _plan_repair_read: no local anchor to plan from)
        primaries = {m_.pg_to_up_acting_osds(pids["clay84"], object_ps(coid[i], pg_num))[3]
                     for i in range(n_clay)}
        clay_victim = next(o for o in range(n_osds) if o not in primaries and o != victim)
        before = victim_shards(clay_victim, pids["clay84"])
        l0, a0 = launches(), rows("clay84")
        clay_s = wipe_and_revive(clay_victim)
        a1, l1 = rows("clay84"), launches()
        per_phase[28] = {n: l1[n] - l0[n] for n in l1}
        got = victim_shards(clay_victim, pids["clay84"])
        check(got == before, f"phase 28: osd.{clay_victim}'s CLAY shards differ")
        reps = a1["repairs"] - a0["repairs"]
        gathers = a1["full_gathers"] - a0["full_gathers"]
        helper_reads = a1["helper_reads"] - a0["helper_reads"]
        # every shard has a planned rebuild (d helpers' repair planes, one
        # K2 apply); a rebuild retried after a push to the returning OSD
        # failed may take the broad gather, which the accounting counts
        check(reps - gathers >= len(before),
              f"phase 28: {reps - gathers} planned rebuilds for {len(before)} shards")
        check(per_phase[28]["gf_apply_k2"] >= len(before),
              f"phase 28: {per_phase[28]['gf_apply_k2']} K2 launches for {len(before)} shards")
        for i in range(n_clay):
            check(cio.read(coid[i]) == objs[i], f"phase 28: {coid[i]} reads back wrong")
        clay_read = a1["bytes_read"] - a0["bytes_read"]
        chunk = len(next(iter(before.values())))
        log(f"[28 CLAY(8,4,d=11)] pool peered in {peer_s['clay84']:.1f} s, "
            f"{pg_num - len(full_pgs)} of its {pg_num} PGs with a slot left empty; "
            f"{n_clay} x {obj_bytes >> 20} MiB written "
            f"({rate(cw_lat, cw_wall, n_clay * obj_bytes)}); osd.{clay_victim} back empty, "
            f"clean in {clay_s:.2f} s: {len(before)} shards of {chunk} B, {reps} rebuilds "
            f"({reps - gathers} planned, {gathers} broad gathers), {helper_reads} helper reads, "
            f"{clay_read / 2**20:.2f} MiB read against {reps * k * chunk / 2**20:.2f} MiB for "
            f"full-decode repairs ({clay_read / (reps * k * chunk):.3f}); launches "
            f"{per_phase[28]}")

        # 29. a flipped byte in one stored shard: deep scrub reports and repairs it
        l0 = launches()
        ps = object_ps(oid[1], pg_num)
        m_ = c._leader().osdmon.osdmap
        _u, _up, acting, primary = m_.pg_to_up_acting_osds(pids["rs84"], ps)
        bad = next(o for o in acting if o >= 0 and o != primary)
        cid = f"{pids['rs84']}.{ps}s{acting.index(bad)}"
        store = c.osds[bad].store
        orig = bytes(store.read(cid, oid[1]))
        tx = Transaction()
        tx.write(cid, oid[1], 0, bytes([orig[0] ^ 0xFF]) + orig[1:])
        store.queue_transaction(tx)
        t0 = time.perf_counter()
        report = io.scrub_pg(ps)
        scrub_s = time.perf_counter() - t0
        check(bool(report.get("repaired")), f"phase 29: scrub did not repair: {report}")
        check(bytes(store.read(cid, oid[1])) == orig, "phase 29: the shard was not restored")
        check(not io.scrub_pg(ps).get("inconsistent"), "phase 29: still inconsistent")
        check(io.read(oid[1]) == objs[1], "phase 29: the object reads back wrong")
        l1 = launches()
        per_phase[29] = {n: l1[n] - l0[n] for n in l1}
        log(f"[29 deep scrub] osd.{bad} shard of {oid[1]} corrupted: reported and repaired "
            f"in {scrub_s:.2f} s, reads back equal; launches {per_phase[29]}")
    finally:
        c.stop()

    total = {n: sum(p[n] for p in per_phase.values()) for n in gf_kernels.KERNELS}
    log(f"[cluster path] launches {total} by phase {per_phase}")
    for name in gf_kernels.KERNELS:
        check(total[name] > 0, f"{name} was not launched on the cluster path")

    # K1 and K2 at the cluster path's launch shapes
    rs = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "torch", "technique": "cauchy_good", "k": str(k), "m": str(m)})
    clay = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "clay", "k": str(k), "m": str(m), "d": str(d)})
    lost = [j for j in range(k + m) if j != 1][:k]
    dm, _ = rs.bitplane._decode_entry(tuple(lost))
    M = clay.repair_matrix(0, tuple(range(1, d + 1)))
    sub = clay.get_chunk_size(obj_bytes) // clay.get_sub_chunk_count()
    cases = (
        ("gf_apply_k1", "ceph_tpu/ops/pallas_gf.py:184", rs.coding, L,
         f"cluster write (phase 25): one 4 MiB object's RS(8,4) stripe [8, {L}]"),
        ("gf_apply_k1", "ceph_tpu/ops/pallas_gf.py:184", dm, L,
         f"cluster degraded read (phase 26): RS(8,4) decode [8, 8] x {L}"),
        ("gf_apply_k2", "ceph_tpu/ops/pallas_gf.py:202", M, sub,
         f"cluster CLAY(8,4,d=11) planned repair (phase 28): [{M.shape[0]}, {M.shape[1]}] "
         f"x {sub}"),
    )
    entries = []
    for name, replaces, mat, cols, shape in cases:
        x = rand_bytes(torch, (mat.shape[1], cols), SEED + 29, dev)
        tables = TABLES.get(mat, dev)
        got = gf_apply(mat, [x], tables=tables)
        plain = apply_matrix_plain(mat, x)
        torch.cuda.synchronize()
        err = max_err(torch, got, plain)
        check(err == 0, f"{name} disagrees with the plain version at {shape}")
        ms, host_ms = time_ms(torch, gf_kernels.prepare(mat, [x], tables), iters=20,
                              label=f"{name} at {shape} (staged launch)")
        wrapper_ms, wrapper_host_ms = time_ms(
            torch, lambda: gf_apply(mat, [x], tables=tables), iters=20,
            label=f"gf_apply at {shape}")
        plain_ms, _ = time_ms(torch, lambda: apply_matrix_plain(mat, x), iters=3, warmup=1)
        bound = bound_ms(*mat.shape, cols)
        entries.append({
            "name": name, "route": "cuda", "source": "ceph_tpu_torch/csrc/gf_apply.cu",
            "replaces": replaces, "launches": total[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "wrapper_ms": wrapper_ms, "host_ms": host_ms, "wrapper_host_ms": wrapper_host_ms,
            "shape": shape,
            "launches_by_phase": {p: v[name] for p, v in per_phase.items()},
            "card": card, "nvidia_smi": smi,
            **({"tc_floor_ms": tc_floor_ms(*mat.shape, cols)} if name == "gf_apply_k2" else {}),
        })
        note = (f"; {k1_note(*mat.shape, [cols], dev)}" if name == "gf_apply_k1" else
                f", int8 tensor-core floor {tc_floor_ms(*mat.shape, cols):.4f} ms")
        log(f"[29 {name}] {shape}: {ms:.4f} ms, bound {bound:.4f} ms by bytes{note}, "
            f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms")
    return entries


# ---- phases 30-32: the mgr, its placement scan and balancer, on the card ----


def profiled(torch, fn, ck) -> tuple[object, dict]:
    """`fn()` once under torch.profiler: its result, and its wall seconds
    (card synchronised), K3's device seconds, the card's idle share (one
    less the device's busy time over the wall time) and K3's launches."""
    from torch.profiler import ProfilerActivity, profile

    k0 = ck.LAUNCHES["crush_straw2_k3"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e6
    k3_s = sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if "straw2" in e.key) / 1e6
    return out, {"wall": wall, "k3": k3_s, "idle": 1 - busy / wall,
                 "launches": ck.LAUNCHES["crush_straw2_k3"] - k0}


def stub_mgr(cct, m):
    """What the placement and balancer modules reach of MgrDaemon, with
    no cluster: the map and a mon-command channel (a dry-run balancer
    sends nothing), the daemons' stats (none) and the report sink."""
    exported = []
    mgr = SimpleNamespace(
        cct=cct, mc=SimpleNamespace(osdmap=m, command=lambda cmd: (-1, "no monitor")),
        _modules={}, latest_stats=lambda: {}, pg_degraded_by_pgid=lambda: {},
        exported=exported,
        ingest_local_report=lambda d, c, schema=None: exported.append(d))
    return mgr


def mgr_placement_slice(torch, dev, card: str, smi: str, om) -> list[dict]:
    """Phase 30: the mgr's PlacementModule and BalancerModule on phase
    22's map, decoded as the mgr's MonClient decodes a map (on its
    context's device, cuda), with no cluster."""
    from ceph_tpu_torch.common.context import CephContext
    from ceph_tpu_torch.mgr.balancer_module import BalancerModule
    from ceph_tpu_torch.mgr.placement_module import PlacementModule
    from ceph_tpu_torch.osd import OSDMap
    from ceph_tpu_torch.osd.placement import diff_mappings
    from ceph_tpu_torch.ops import crush_kernels as ck

    cct = CephContext("mgr.x", overrides={"mgr_balancer_active": False}, device="cuda")
    try:
        m0 = OSDMap.from_json(om.make().to_json(), device=cct.device)
        mgr = stub_mgr(cct, m0)
        pm, bal = PlacementModule(mgr), BalancerModule(mgr)
        mgr._modules.update(placement=pm, balancer=bal)

        # ---- the mgr's placement path: counts set to 0 here, read after the pass ----
        ck.reset_launch_counts()
        built0 = ck.MAGIC_BUILDS
        # 30a. the scan: one map_pool a pool, scored; then the same scan
        # under torch.profiler
        t0 = time.perf_counter()
        report = pm.scan()
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        scan_launches = ck.LAUNCHES["crush_straw2_k3"]
        check(m0.device.type == "cuda", f"the mgr's map is on {m0.device}")
        for pid, (up, prim) in om.base.items():
            sup, sprim = pm._mappings[pid]
            check(np.array_equal(sup, up) and np.array_equal(sprim, prim),
                  f"phase 30: the scan's pool {pid} differs from phase 22's mappings")
        _, prof_scan = profiled(torch, pm.scan, ck)
        # 30b. phase 23's changes in the next epoch: the forecast equals
        # the diff of phase 22's and phase 23's mappings
        m1 = OSDMap.from_json(m0.to_json(), device=cct.device)
        m1.pg_upmap_items.update(om.items)
        for o in om.low_aff:
            m1.set_primary_affinity(o, 0.0)
        for o in om.out_osds:
            m1.mark_out(o)
        mgr.mc.osdmap = m1
        k0 = ck.LAUNCHES["crush_straw2_k3"]
        t0 = time.perf_counter()
        pm.scan()
        torch.cuda.synchronize()
        diff_s = time.perf_counter() - t0
        diff_launches = ck.LAUNCHES["crush_straw2_k3"] - k0
        for pid, (up, prim) in om.after.items():
            sup, sprim = pm._mappings[pid]
            check(np.array_equal(sup, up) and np.array_equal(sprim, prim),
                  f"phase 30: the scan's pool {pid} after the changes differs from phase 23's")
        want = diff_mappings(m1, {pid: up for pid, (up, _p) in om.base.items()},
                             {pid: up for pid, (up, _p) in om.after.items()},
                             shard_bytes=pm._shard_bytes(m1))
        got = {k: v for k, v in pm._last_diff.items() if k not in ("from_epoch", "to_epoch")}
        check(got == want, f"phase 30: the remap forecast {got} differs from {want}")
        check(got["pgs_remapped"] > 0, "phase 30: the forecast moved no PG")
        log(f"[30 placement scan] {len(om.pools)} pools, {sum(om.base[p][0].shape[0] for p in om.pools)} "
            f"PGs on {m0.max_osd} OSDs, mappings equal to phase 22's: {scan_s * 1e3:.1f} ms "
            f"wall, {scan_launches} K3 launches; under torch.profiler {prof_scan['wall'] * 1e3:.1f} ms "
            f"wall, K3 {prof_scan['k3'] * 1e3:.3f} ms on the card, idle share "
            f"{prof_scan['idle']:.4f}; score {report['score']:.4f}, max deviation "
            f"{report['max_deviation']:.2f}; card {card}, {smi}")
        log(f"[30 remap forecast] phase 23's changes (epoch {m0.epoch} -> {m1.epoch}): "
            f"{got['pgs_remapped']} PGs, {got['shards_remapped']} shards remapped, misplaced "
            f"fraction {got['misplaced_fraction']:.6f}, equal to diff_mappings of phase 22's "
            f"and 23's mappings; {diff_s * 1e3:.1f} ms wall, {diff_launches} K3 launches")

        # 30c. one dry-run balancer pass on the live map (phase 22's state):
        # its proposals equal calc_pg_upmaps on phase 24's mappings
        mgr.mc.osdmap = m0
        k0 = ck.LAUNCHES["crush_straw2_k3"]
        t0 = time.perf_counter()
        changes = bal.optimize_once()
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        pass_launches = ck.LAUNCHES["crush_straw2_k3"] - k0
        check([tuple(int(v) for v in c) for c in changes]
              == [tuple(int(v) for v in c) for c in om.upmaps24],
              f"phase 30: the balancer proposed {len(changes)} changes, calc_pg_upmaps on "
              f"phase 24's mappings {len(om.upmaps24)}, or others")
        check(not m0.pg_upmap_items, "phase 30: a dry-run pass changed the live map")
        _, prof_pass = profiled(torch, bal.optimize_once, ck)
        lp = bal.status()["last_pass"]
        torch.cuda.synchronize()
        total = ck.LAUNCHES["crush_straw2_k3"]
        check(scan_launches > 0, "phase 30: the placement scan did not launch K3")
        check(pass_launches > 0, "phase 30: the balancer pass did not launch K3")
        check(ck.MAGIC_BUILDS == built0, "phase 30: K3's magic was built in the wrapper")
        log(f"[30 balancer pass] dry run: {len(changes)} changes equal to calc_pg_upmaps on "
            f"phase 24's mappings, score {lp['score_before']['score']} -> "
            f"{lp['score_after']['score']}: {pass_s * 1e3:.1f} ms wall, {pass_launches} K3 "
            f"launches; under torch.profiler {prof_pass['wall'] * 1e3:.1f} ms wall, K3 "
            f"{prof_pass['k3'] * 1e3:.3f} ms on the card, idle share {prof_pass['idle']:.4f}; "
            f"card {card}, {smi}")
        log(f"[mgr placement path] crush_straw2_k3 launches {total}: scan {scan_launches}, "
            f"next-epoch scan {diff_launches}, pass {pass_launches}, profiled runs "
            f"{prof_scan['launches']} + {prof_pass['launches']}")
        entries = map_pool_k3_rows(
            torch, dev, ck, om.sass, m0, "30", "mgr placement scan and balancer pass",
            {pid: f"{scan_launches} K3 launches a scan, {pass_launches} a pass"
             for pid in m0.pools}, card, smi)
        for e in entries:
            e["launches"] = total
            e["launches_per_scan"] = scan_launches
            e["launches_per_pass"] = pass_launches
        return entries
    finally:
        cct.shutdown()


def mgr_cluster_slice(torch, dev, card: str, smi: str, sass: dict) -> list[dict]:
    """Phase 31: a port LocalCluster with the mgr on the card (one mon,
    12 OSDs, the default mgr_modules), an RS(8,4) pool of pg_num 64 and a
    size-3 pool of pg_num 128 (96 PG shards an OSD, about Ceph's
    mon_target_pg_per_osd of 100): librados writes through K1, the
    exporter's series, the placement scan on the mgr's own thread through
    K3, one active balancer pass whose upmaps commit, and `ceph -s`.

    The mgr's scan and pass share the interpreter lock with the 12 OSDs:
    each of a scan's ~1300 draws (a 12-wide pool on exactly 12 OSDs
    retries) gives it up at its syncs and its launch.  While every
    OSD's recovery pass queried every peer of every PG each second, a
    scan took 102-163 s and a pass 389-409 s on the H100; the passes now
    skip PGs found clean (osd/recovery.py, CLEAN_REPOLL_S)."""
    import urllib.request

    from ceph_tpu_torch.ops import crush_kernels as ck
    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.ops.gf_kernels import apply_matrix_plain, gf_apply
    from ceph_tpu_torch.ops.bitplane import TABLES
    from ceph_tpu_torch.osd.osdmap import object_ps
    from ceph_tpu_torch.qa import LocalCluster

    k, m, n_osds, pools = 8, 4, 12, (("rs84", 64), ("rep3", 128))
    n_obj, obj_bytes = CLUSTER_CLAY_OBJECTS, CLUSTER_OBJECT_BYTES
    rng = np.random.default_rng(SEED + 31)
    objs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8).tobytes() for _ in range(n_obj)]

    def k3() -> int:
        torch.cuda.synchronize()
        return ck.LAUNCHES["crush_straw2_k3"]

    # balancer passes on demand (the pass below), not on its 10 s timer
    c = LocalCluster(n_mons=1, n_osds=n_osds, with_mgr=True,
                     conf_overrides={"mgr_balancer_interval": 3600.0})  # device: cuda
    t0 = time.perf_counter()
    c.start()
    start_s = time.perf_counter() - t0
    try:
        mgr = c.mgr
        check(mgr.device.type == "cuda" and mgr.cct.device.type == "cuda",
              f"the mgr runs on {mgr.device}")
        pm, bal = mgr.module("placement"), mgr.module("balancer")
        scans = []
        real_scan = pm.scan

        def scan():  # the serve loop's scans: thread, K3 launches, seconds
            k0, t0 = k3(), time.perf_counter()
            out = real_scan()
            scans.append((threading.current_thread().name, k3() - k0,
                          time.perf_counter() - t0))
            return out
        pm.scan = scan

        # ---- the mgr cluster path: counts set to 0 here, read after the pass ----
        ck.reset_launch_counts()
        gf_kernels.reset_launch_counts()
        c.create_ec_pool("rs84", k=k, m=m, pg_num=pools[0][1], plugin="torch",
                         extra_profile={"technique": "cauchy_good"})
        c.create_replicated_pool("rep3", size=3, pg_num=pools[1][1])
        client = c.client()
        io = client.open_ioctx("rs84")
        peer_s = {name: wait_peered(c, client.pool_id(name), n) for name, n in pools}

        # the placement scan on the mgr's thread: the pools' epochs woke it
        t0 = time.perf_counter()
        while not any(t.startswith("mgr-placement") and n > 0 for t, n, _s in scans):
            check(time.perf_counter() - t0 < 300,
                  f"phase 31: no scan with K3 on the mgr's thread: {scans}, "
                  f"failed modules {mgr.failed_modules}")
            time.sleep(0.2)
        rep = pm._report
        log(f"[31 placement scan] pools peered in {peer_s} s; {len(scans)} scans so far "
            f"on {sorted({t for t, _n, _s in scans})}: K3 launches "
            f"{[n for _t, n, _s in scans]}, seconds {[round(x, 2) for _t, _n, x in scans]}; "
            f"epoch {rep['epoch']} score {rep['score']:.4f}, max deviation "
            f"{rep['max_deviation']:.2f}")

        # objects in PGs whose 12 slots CRUSH filled: a slot left empty on
        # exactly 12 OSDs counts its objects degraded, and the balancer
        # refuses to run while any object is degraded
        pid = client.pool_id("rs84")
        mm = c._leader().osdmon.osdmap
        full = {ps for ps in range(pools[0][1])
                if min(mm.pg_to_up_acting_osds(pid, ps)[2]) >= 0}
        oid = [o for o in (f"mgr_{j}" for j in range(64 * n_obj))
               if object_ps(o, pools[0][1]) in full][:n_obj]
        l0 = dict(gf_kernels.LAUNCHES)
        w_lat, w_wall = run_ops(n_obj, n_obj, lambda i: io.write_full(oid[i], objs[i]))
        for i in range(n_obj):
            check(io.read(oid[i]) == objs[i], f"phase 31: {oid[i]} reads back wrong")
        torch.cuda.synchronize()
        k1_writes = gf_kernels.LAUNCHES["gf_apply_k1"] - l0["gf_apply_k1"]
        check(k1_writes > 0, "phase 31: the writes did not launch K1")
        for name, _n in pools:  # every shard written, so no object degraded
            c.wait_clean(name, timeout=300)
        log(f"[31 mgr cluster] 1 mon, {n_osds} OSDs and the mgr ({sorted(mgr._modules)}) up "
            f"in {start_s:.1f} s; {n_obj} x {obj_bytes >> 20} MiB written through librados "
            f"({rate(w_lat, w_wall, n_obj * obj_bytes)}), read back equal, {k1_writes} K1 "
            f"launches")

        # the exporter: OSD counters, the placement series, the card's probe rows
        url = mgr.module("prometheus").url
        body = ""

        def scraped() -> bool:
            nonlocal body
            body = urllib.request.urlopen(url, timeout=10).read().decode()
            return ("ceph_osd_op{" in body and "ceph_placement_osd_shards{" in body
                    and re.search(r'ceph_backend_device_ok\{[^}]*device="cuda', body) is not None)
        t0 = time.perf_counter()
        while not scraped():
            check(time.perf_counter() - t0 < 120, "phase 31: the exporter lacks a series: "
                  + ", ".join(s for s in ("ceph_osd_op{", "ceph_placement_osd_shards{",
                                          'device="cuda') if s not in body))
            time.sleep(0.5)
        series = sorted({ln.split("{")[0].split(" ")[0] for ln in body.splitlines()
                         if ln.startswith(("ceph_osd_", "ceph_placement_", "ceph_backend_device_"))})
        log(f"[31 prometheus] {len(body.splitlines())} lines, {len(series)} ceph_osd_*, "
            f"ceph_placement_* and ceph_backend_device_* series, "
            f"{[ln for ln in body.splitlines() if ln.startswith('ceph_backend_device_ok')]}")

        # one active balancer pass: its upmaps commit and a new epoch carries them
        epoch0 = mgr.mc.osdmap.epoch
        k0 = k3()
        t0 = time.perf_counter()
        changes = bal.optimize_once()
        pass_s = time.perf_counter() - t0
        pass_launches = k3() - k0
        st = bal.status()
        check(st["passes"] == 1 and not st["passes_skipped"],
              f"phase 31: the pass did not run: {st.get('last_skip')}")
        check(changes and st["moves_committed"] == len(changes),
              f"phase 31: {len(changes)} changes, {st['moves_committed']} committed, "
              f"{st['last_error']}")
        t0 = time.perf_counter()
        while not (mgr.mc.osdmap.epoch > epoch0 and mgr.mc.osdmap.pg_upmap_items):
            check(time.perf_counter() - t0 < 30, "phase 31: no map carries the upmaps")
            time.sleep(0.2)
        check(pass_launches > 0, "phase 31: the balancer pass did not launch K3")
        log(f"[31 balancer pass] {len(changes)} moves committed in {pass_s * 1e3:.1f} ms "
            f"({pass_launches} K3 launches), score {st['last_pass']['score_before']['score']} "
            f"-> {st['last_pass']['score_after']['score']}; epoch {epoch0} -> "
            f"{mgr.mc.osdmap.epoch} carries {len(mgr.mc.osdmap.pg_upmap_items)} pg_upmap_items")

        # `ceph -s` answers from the mgr's digest
        t0 = time.perf_counter()
        while True:
            rv, status = c.mon_command({"prefix": "status"})
            if rv == 0 and (status.get("usage") or {}).get("total_bytes") and \
                    status.get("pgs_by_state"):
                break
            check(time.perf_counter() - t0 < 30, f"phase 31: `ceph -s` lacks the digest: {rv}")
            time.sleep(0.5)
        log(f"[31 ceph -s] usage {status['usage']}, pgs {status['pgs_by_state']}, health "
            f"{(status.get('health') or {}).get('status')}")
        check(mgr.failed_modules == {}, f"phase 31: mgr modules died: {mgr.failed_modules}")
        launches = {"crush_straw2_k3": k3(), **dict(gf_kernels.LAUNCHES)}
        log(f"[mgr cluster path] launches {launches}")
        check(launches["gf_apply_k1"] > 0 and launches["crush_straw2_k3"] > 0,
              "phase 31: a kernel of the path was not launched")
        final = mgr.mc.osdmap
    finally:
        c.stop()

    # K1 at the write's launch shape and K3 at the scan's, on the mgr's map
    entries = map_pool_k3_rows(
        torch, dev, ck, sass, final, "31",
        "mgr placement scan in the cluster", dict.fromkeys(final.pools, "on the mgr's thread"),
        card, smi)
    for e in entries:
        e["launches"] = launches["crush_straw2_k3"]
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    rs = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "torch", "technique": "cauchy_good", "k": str(k), "m": str(m)})
    L = rs.get_chunk_size(obj_bytes)
    x = rand_bytes(torch, (k, L), SEED + 31, dev)
    tables = TABLES.get(rs.coding, dev)
    err = max_err(torch, gf_apply(rs.coding, [x], tables=tables), apply_matrix_plain(rs.coding, x))
    check(err == 0, "phase 31: K1 disagrees with the plain version")
    ms, host_ms = time_ms(torch, gf_kernels.prepare(rs.coding, [x], tables), iters=20)
    plain_ms, _ = time_ms(torch, lambda: apply_matrix_plain(rs.coding, x), iters=3, warmup=1)
    entries.append({
        "name": "gf_apply_k1", "route": "cuda", "source": "ceph_tpu_torch/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:184", "launches": launches["gf_apply_k1"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(m, k, L),
        "bound_by": "bytes", "library_ms": None, "host_ms": host_ms,
        "shape": f"mgr cluster write (phase 31): one 4 MiB object's RS(8,4) stripe [8, {L}]",
        "card": card, "nvidia_smi": smi})
    log(f"[31 gf_apply_k1] [8, {L}]: {ms:.4f} ms, bound {bound_ms(m, k, L):.4f} ms by bytes, "
        f"plain {plain_ms:.3f} ms")
    return entries


def recovery_smoke_slice(torch, dev, card: str, smi: str) -> list[dict]:
    """Phase 32: the port's recovery smoke (qa/recovery_smoke.py) on the
    card, the monitor's failure detector at its default grace: k + m = 3
    OSDs with the mgr hosted, two writers, a kill, a revive and drain, the
    prometheus series and a tail-promoted trace."""
    import contextlib

    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.ops.bitplane import TABLES
    from ceph_tpu_torch.ops.gf_kernels import apply_matrix_plain, gf_apply
    from ceph_tpu_torch.qa import recovery_smoke

    gf_kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = recovery_smoke.main(["--device", "cuda"])
    smoke_s = time.perf_counter() - t0
    summary = json.loads(buf.getvalue())
    torch.cuda.synchronize()
    launches = dict(gf_kernels.LAUNCHES)
    log(f"[32 recovery smoke] exit {rc} in {smoke_s:.1f} s, K1 launches "
        f"{launches['gf_apply_k1']}: {json.dumps(summary)}")
    check(rc == 0, f"phase 32: the recovery smoke failed: {summary['problems']}")
    check(launches["gf_apply_k1"] > 0, "phase 32: the recovery smoke did not launch K1")

    # K1 at the smoke's write: one 4 KiB object's RS(2,1) stripe
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    rs = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "torch", "k": str(recovery_smoke.K), "m": str(recovery_smoke.M)})
    L = rs.get_chunk_size(recovery_smoke.WSIZE)
    x = rand_bytes(torch, (recovery_smoke.K, L), SEED + 32, dev)
    tables = TABLES.get(rs.coding, dev)
    err = max_err(torch, gf_apply(rs.coding, [x], tables=tables), apply_matrix_plain(rs.coding, x))
    check(err == 0, "phase 32: K1 disagrees with the plain version")
    ms, host_ms = time_ms(torch, gf_kernels.prepare(rs.coding, [x], tables), iters=20)
    plain_ms, _ = time_ms(torch, lambda: apply_matrix_plain(rs.coding, x), iters=3, warmup=1)
    rows, n = rs.coding.shape
    log(f"[32 gf_apply_k1] [{rows}, {n}] x {L}: {ms:.4f} ms, bound "
        f"{bound_ms(rows, n, L):.6f} ms by bytes, plain {plain_ms:.3f} ms")
    return [{
        "name": "gf_apply_k1", "route": "cuda", "source": "ceph_tpu_torch/csrc/gf_apply.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:184", "launches": launches["gf_apply_k1"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(rows, n, L),
        "bound_by": "bytes", "library_ms": None, "host_ms": host_ms,
        "shape": f"recovery smoke write (phase 32): one 4 KiB object's RS(2,1) stripe "
                 f"[{n}, {L}]",
        "card": card, "nvidia_smi": smi}]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    try:
        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
        from ceph_tpu_torch.ec.stripe import StripeInfo
        from ceph_tpu_torch.gf.matrix import decode_matrix_for, systematic_generator
        from ceph_tpu_torch.gf.reference_codec import encode_chunks as ref_encode
        from ceph_tpu_torch.ops import crush_kernels, gf_kernels
        from ceph_tpu_torch.ops.bitplane import TABLES
        from ceph_tpu_torch.ops.gf_kernels import (
            apply_matrix_plain, gf_apply, k2_layout, kernel_for)
    except ImportError as e:
        print(f"chip_smoke: the ceph_tpu_torch package is missing ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    reg = ErasureCodePluginRegistry.instance()
    t_start = time.perf_counter()

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"[1 card] {card}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build every kernel library at once, one nvcc each
    t0 = time.perf_counter()
    errors = []

    def build(module) -> None:
        try:
            module.library()
        except Exception as e:  # reported and raised below
            errors.append(e)

    builders = [threading.Thread(target=build, args=(m,))
                for m in (gf_kernels, crush_kernels)]
    for b in builders:
        b.start()
    for b in builders:
        b.join()
    if errors:
        raise errors[0]
    log(f"[2 build] {time.perf_counter() - t0:.1f} s; rule: K1 when rows <= "
        f"{gf_kernels.MAX_ROWS} and rows*n*{gf_kernels.TABLE_BYTES_PER_ENTRY} <= "
        f"{gf_kernels.K1_MAX_TABLE_BYTES} table bytes, else K2, the bitplane product "
        f"on the tensor cores in blocks of {gf_kernels.K2_TILE_ROWS} rows x "
        f"{gf_kernels.K2_TILE_COLS} columns (k2_layout)")
    for lib in (gf_kernels.LIBRARY, crush_kernels.LIBRARY):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    ptxas {lib.source.name}: {line.strip()}")
    check(imma_count(gf_kernels.LIBRARY.path()) > 0, "gf_apply_k2's SASS holds no IMMA")
    k1_loop_counts(gf_kernels.LIBRARY.path())
    log(f"[2 build] K1: tiles (threads, vecs) {gf_kernels.K1_TILES}, the largest with two "
        f"blocks an SM (k1_layout); up to {gf_kernels.K1_PARAM_SEGS} segment descriptors "
        f"by value")

    def against_plain(mat, x, want_kernel: str) -> None:
        check(kernel_for(*mat.shape) == want_kernel,
              f"{mat.shape} routes to {kernel_for(*mat.shape)}, want {want_kernel}")
        got = gf_apply(mat, [x])
        plain = apply_matrix_plain(mat, x)
        torch.cuda.synchronize()
        err = int((got.int() - plain.int()).abs().max()) if got.numel() else 0
        check(err == 0, f"{want_kernel} {mat.shape} disagrees with the plain version")

    # 3. K1 against the plain version (L = 3000: ragged)
    rs84 = reg.factory({"plugin": "torch", "technique": "cauchy_good", "k": "8", "m": "4"})
    rs21 = reg.factory({"plugin": "torch", "technique": "reed_sol_van", "k": "2", "m": "1"})
    lost = (1, 4, 9, 11)
    avail = [i for i in range(12) if i not in lost]
    dm84 = decode_matrix_for(systematic_generator(rs84.coding), 8, avail).astype(np.uint8)
    for name, mat in (("RS(8,4) encode", rs84.coding), ("RS(2,1) encode", rs21.coding),
                      ("RS(8,4) decode", dm84)):
        x = rand_bytes(torch, (mat.shape[1], 3000), SEED + mat.size, dev)
        against_plain(mat, x, "gf_apply_k1")
        log(f"[3 K1] {name} {mat.shape} x L=3000: bytes equal; "
            f"{k1_note(*mat.shape, [3000], dev)}")

    # 4. K2 against the plain version, CLAY(12,4,d=15)'s [256, 960] repair too
    clay = reg.factory({"plugin": "clay", "k": "8", "m": "4"})
    chunk = clay.get_chunk_size(8 * (4 << 20))
    Z = clay.get_sub_chunk_count()
    helpers = tuple(range(1, 12))
    M_rep = clay.repair_matrix(0, helpers)
    ragged = np.random.default_rng(SEED).integers(0, 256, (13, 40), dtype=np.uint8)
    wide = reg.factory({"plugin": "clay", "k": "12", "m": "4", "d": "15"}
                       ).repair_matrix(0, tuple(range(1, 16)))
    for name, mat in (("CLAY repair", M_rep), ("ragged", ragged),
                      ("CLAY(12,4,d=15) repair", wide)):
        x = rand_bytes(torch, (mat.shape[1], 3000), SEED + 7, dev)
        against_plain(mat, x, "gf_apply_k2")
        lay = k2_layout(*mat.shape, 3000)
        log(f"[4 K2] {name} {mat.shape} x L=3000 ({lay.row_tiles} x {lay.col_tiles} "
            f"blocks, {lay.op_pitch // gf_kernels.K2_STAGE_ROWS} stages of K): bytes equal")

    # ---- the main path: counts set to 0 here, read after phase 8 ----
    gf_kernels.reset_launch_counts()

    # 5. RS(8,4) write of 256 x 1 MiB objects and their degraded read
    t0 = time.perf_counter()
    si = StripeInfo(k=8, stripe_unit=STRIPE_UNIT)
    objects = rand_bytes(torch, (OBJECTS, OBJECT_BYTES), SEED + 5, dev)
    stripes = [si.shard_layout(objects[o]) for o in range(OBJECTS)]
    S = si.shard_size(OBJECT_BYTES)
    k1_before = gf_kernels.LAUNCHES["gf_apply_k1"]
    parity = rs84.bitplane.encode_many(stripes)  # one fused flush
    torch.cuda.synchronize()
    check(gf_kernels.LAUNCHES["gf_apply_k1"] == k1_before + 1,
          "the fused flush took more than one launch")
    check(tuple(parity.shape) == (4, OBJECTS * S), f"parity shape {tuple(parity.shape)}")
    ref = ref_encode(rs84.coding, stripes[0].cpu().numpy())
    check(np.array_equal(parity[:, :S].cpu().numpy(), ref),
          "object 0's parity differs from the numpy reference codec")
    # erase shards 1, 4, 9, 11 of every object; the read gathers each
    # surviving shard across the objects and decodes them in one call
    have = {j: torch.cat([s[j] for s in stripes]) for j in range(8) if j not in lost}
    have.update({8 + p: parity[p] for p in range(4) if 8 + p not in lost})
    need = rs84.minimum_to_decode(set(range(8)), set(have))
    got = rs84.decode(set(range(8)), {c: have[c] for c in need}, OBJECTS * S)
    data = torch.stack([got[j] for j in range(8)])
    readback = torch.stack([si.unshard(data[:, o * S:(o + 1) * S], OBJECT_BYTES)
                            for o in range(OBJECTS)])
    check(torch.equal(readback, objects), "the degraded read differs from the written bytes")
    shards = torch.stack([have[c] for c in avail[:8]])
    rebuilt = rs84.bitplane.reconstruct(avail, shards, [9, 11])
    check(torch.equal(rebuilt, parity[[1, 3]]), "reconstructed parity differs")
    torch.cuda.synchronize()
    log(f"[5 RS(8,4)] 256 x 1 MiB: fused encode in 1 launch, degraded read "
        f"{OBJECTS * OBJECT_BYTES >> 20} MiB equal, parity 9 and 11 rebuilt "
        f"({time.perf_counter() - t0:.2f} s)")

    # 6. RS(2,1) reed_sol_van: 128 MiB encode, decode with shard 0 lost
    t0 = time.perf_counter()
    d21 = rand_bytes(torch, (2, 64 << 20), SEED + 6, dev)
    p21 = rs21.encode_chunks(d21)
    got = rs21.decode({0}, {1: d21[1], 2: p21[0]}, 64 << 20)
    check(torch.equal(got[0], d21[0]), "RS(2,1) decode differs")
    log(f"[6 RS(2,1)] 128 MiB encode, shard 0 rebuilt equal "
        f"({time.perf_counter() - t0:.2f} s)")

    # 7. SHEC(6,3,2): lose chunk 2, 8 MiB chunks
    t0 = time.perf_counter()
    shec = reg.factory({"plugin": "shec", "k": "6", "m": "3", "c": "2"})
    d63 = rand_bytes(torch, (6, 8 << 20), SEED + 7, dev)
    p63 = shec.encode_chunks(d63)
    all63 = {i: d63[i] for i in range(6)}
    all63.update({6 + i: p63[i] for i in range(3)})
    need = shec.minimum_to_decode({2}, set(all63) - {2})
    got = shec.decode({2}, {c: all63[c] for c in need}, 8 << 20)
    check(torch.equal(got[2], d63[2]), "SHEC decode differs")
    log(f"[7 SHEC(6,3,2)] chunk 2 rebuilt from {len(need)} chunks, equal "
        f"({time.perf_counter() - t0:.2f} s)")

    # 8. CLAY(8,4,d=11): repair shard 0 from the 11 helpers, ~4 MiB chunks
    t0 = time.perf_counter()
    d84 = rand_bytes(torch, (8, chunk), SEED + 8, dev)
    pc = clay.encode_chunks(d84)
    allc = {i: d84[i] for i in range(8)}
    allc.update({8 + i: pc[i] for i in range(4)})
    got = clay.decode({0}, {c: allc[c] for c in helpers}, chunk)
    check(torch.equal(got[0], d84[0]), "CLAY repair differs")
    log(f"[8 CLAY(8,4,d=11)] shard 0 repaired from 11 helpers, chunk {chunk} B, "
        f"equal ({time.perf_counter() - t0:.2f} s)")

    torch.cuda.synchronize()
    launches = dict(gf_kernels.LAUNCHES)
    log(f"[main path] launches {launches}")
    for name in gf_kernels.KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the main path")

    # 9. the kernels line, at the main path's shapes
    kernels = []
    wide_in = rand_bytes(torch, wide.shape[1:] + (16384,), SEED + 9, dev)
    cases = (
        ("gf_apply_k1", "ceph_tpu/ops/pallas_gf.py:184", rs84.coding, stripes,
         "RS(8,4) fused encode, 256 stripes of [8, 131072]"),
        ("gf_apply_k2", "ceph_tpu/ops/pallas_gf.py:202", M_rep,
         [clay.gather_repair_input(allc, 0, chunk // Z, helpers)],
         f"CLAY(8,4,d=11) repair [64, 176] x {chunk // Z}"),
        ("gf_apply_k2", "ceph_tpu/ops/pallas_gf.py:202", wide, [wide_in],
         "CLAY(12,4,d=15) repair [256, 960] x 16384 (~4 MiB chunks)"),
    )
    for name, replaces, mat, segs, shape in cases:
        rows, n = mat.shape
        L = sum(s.shape[1] for s in segs)
        tables = TABLES.get(mat, dev)
        got = gf_apply(mat, segs, tables=tables)
        whole = torch.cat(segs, dim=1)
        plain = apply_matrix_plain(mat, whole)
        torch.cuda.synchronize()
        err = int((got.int() - plain.int()).abs().max())
        check(err == 0, f"{name} disagrees with the plain version at {shape}")
        # the kernel alone (a staged launch), then the whole wrapper, whose
        # host work (checks, 256 segment descriptors) the events also see
        ms, host_ms = time_ms(torch, gf_kernels.prepare(mat, segs, tables), iters=20,
                              label=f"{name} at {shape} (staged launch)")
        wrapper_ms, wrapper_host_ms = time_ms(
            torch, lambda: gf_apply(mat, segs, tables=tables), iters=20,
            label=f"gf_apply at {shape}")
        plain_ms, _ = time_ms(torch, lambda: apply_matrix_plain(mat, whole), iters=3, warmup=1)
        bound = bound_ms(rows, n, L)
        moved = (rows + n) * L
        tc = {"tc_floor_ms": tc_floor_ms(rows, n, L)} if name == "gf_apply_k2" else {}
        kernels.append({
            "name": name, "route": "cuda", "source": "ceph_tpu_torch/csrc/gf_apply.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "wrapper_ms": wrapper_ms, "host_ms": host_ms,
            "wrapper_host_ms": wrapper_host_ms, "shape": shape,
            "bytes_moved": moved,
            "gib_per_s": moved / (ms * 1e-3) / 2**30, "card": card, "nvidia_smi": smi,
            **tc,
        })
        log(f"[9 {name}] {shape}: {ms:.4f} ms ({moved / (ms * 1e-3) / 2**30:.1f} GiB/s "
            f"moved), bound {bound:.4f} ms by bytes"
            + (f", tensor-core floor {tc['tc_floor_ms']:.4f} ms" if tc else
               f"; {k1_note(rows, n, [s.shape[1] for s in segs], dev)}")
            + f", wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms")
    kernels += crush_slice(torch, dev, card, smi)
    kernels += osd_slice(torch, dev, card, smi, rs84, stripes, objects, si)
    entries, om = osdmap_slice(torch, dev, card, smi)
    kernels += entries
    kernels += cluster_slice(torch, dev, card, smi)
    kernels += mgr_placement_slice(torch, dev, card, smi, om)
    kernels += mgr_cluster_slice(torch, dev, card, smi, om.sass)
    kernels += recovery_smoke_slice(torch, dev, card, smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
