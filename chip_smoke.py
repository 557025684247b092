#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's erasure-code data plane once on one GPU.

    python3 chip_smoke.py            (from the repo root; needs one CUDA card)

It builds the GF(2^8) kernels (ceph_tpu_torch/csrc/gf_apply.cu) with nvcc,
holds each against its plain PyTorch version, then drives the port's main
path through the entry points a user calls: the RS(8,4) cauchy_good write
of 256 objects of 1 MiB (256 MiB resident on the card) in one fused
encode, their degraded read with shards {1, 4, 9, 11} lost, parity
reconstruction, an RS(2,1) 128 MiB encode and decode, a SHEC(6,3,2)
single-chunk decode and a CLAY(8,4,d=11) single-shard repair.  Every
result is compared byte for byte.  The launch counters show which kernels
the main path ran.  The last lines are the card, one ``kernels`` JSON
object (each kernel's time beside its bound and its plain version's
time), and ``{"ok": true, "device": {...}}``.  Any failure raises and the
exit code is not 0; without a card, or without the ceph_tpu_torch package
beside this script, it exits 1 and prints no result.

Data is random, made on the card from fixed seeds.  Imports torch, numpy
and ceph_tpu_torch only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261017
#: H100 SXM peak HBM bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
OBJECTS = 256
OBJECT_BYTES = 1 << 20
STRIPE_UNIT = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rand_bytes(torch, shape, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=g)


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Median time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def bound_ms(rows: int, n: int, L: int) -> float:
    """Least time (ms) for a [rows, n] apply over L columns: the bytes it
    must move (n*L read, rows*L written) over HBM.  The card has no unit
    that does a GF(2^8) multiply-add as one operation, so there is no
    peak rate to hold the rows*n*L multiply-adds against."""
    return (n + rows) * L / HBM_BYTES_PER_S * 1e3


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
        from ceph_tpu_torch.ops import gf_kernels
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

    # 2. build
    t0 = time.perf_counter()
    gf_kernels.library()
    log(f"[2 build] {time.perf_counter() - t0:.1f} s; rule: K1 when rows <= "
        f"{gf_kernels.MAX_ROWS} and rows*n*{gf_kernels.TABLE_BYTES_PER_ENTRY} <= "
        f"{gf_kernels.K1_MAX_TABLE_BYTES} table bytes, else K2 in bands of "
        f"up to {gf_kernels.MAX_ROWS} rows, the inputs in chunks that fit "
        f"{gf_kernels.SMEM_PER_BLOCK} bytes of shared memory (k2_layout)")
    for line in gf_kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

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
        log(f"[3 K1] {name} {mat.shape} x L=3000: bytes equal")

    # 4. K2 against the plain version; CLAY(12,4,d=15)'s [256, 960] repair
    # takes its inputs in chunks
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
        band, step = k2_layout(*mat.shape)
        log(f"[4 K2] {name} {mat.shape} x L=3000 (bands of {band} rows, inputs "
            f"in chunks of {step}): bytes equal")
    # the chunked form's time at a CLAY(12,4,d=15) repair of ~4 MiB chunks
    x = rand_bytes(torch, wide.shape[1:] + (16384,), SEED + 9, dev)
    wide_ms = time_ms(torch, gf_kernels.prepare(wide, [x]), iters=10)
    log(f"[4 K2] CLAY(12,4,d=15) repair [256, 960] x 16384: {wide_ms:.4f} ms, "
        f"bound {bound_ms(256, 960, 16384):.4f} ms by bytes")

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
    cases = (
        ("gf_apply_k1", "ceph_tpu/ops/pallas_gf.py:184", rs84.coding, stripes,
         "RS(8,4) fused encode, 256 stripes of [8, 131072]"),
        ("gf_apply_k2", "ceph_tpu/ops/pallas_gf.py:202", M_rep,
         [clay.gather_repair_input(allc, 0, chunk // Z, helpers)],
         f"CLAY(8,4,d=11) repair [64, 176] x {chunk // Z}"),
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
        ms = time_ms(torch, gf_kernels.prepare(mat, segs, tables), iters=20)
        wrapper_ms = time_ms(torch, lambda: gf_apply(mat, segs, tables=tables), iters=20)
        plain_ms = time_ms(torch, lambda: apply_matrix_plain(mat, whole), iters=3, warmup=1)
        bound = bound_ms(rows, n, L)
        moved = (rows + n) * L
        kernels.append({
            "name": name, "route": "cuda", "source": "ceph_tpu_torch/csrc/gf_apply.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "wrapper_ms": wrapper_ms, "shape": shape,
            "bytes_moved": moved,
            "gib_per_s": moved / (ms * 1e-3) / 2**30, "card": card, "nvidia_smi": smi,
        })
        log(f"[9 {name}] {shape}: {ms:.4f} ms ({moved / (ms * 1e-3) / 2**30:.1f} GiB/s "
            f"moved), bound {bound:.4f} ms by bytes, wrapper {wrapper_ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
