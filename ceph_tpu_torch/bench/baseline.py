"""BASELINE.json configs 1-5 on the port: one JSON line (the
counterpart of the repository root's bench.py).

    python -m ceph_tpu_torch.bench.baseline              (one CUDA card)
    python -m ceph_tpu_torch.bench.baseline --device cpu --data-mib 1 \
        --iters 2 --crush-pgs 4096 --traffic-seconds 0.5

Each config runs through the same entry points as bench.py's phases:

1. RS(2,1) reed_sol_van encode and 2. RS(8,4) cauchy_good encode: a
   chained encode (bench/timing.py, one K1 launch an iteration) over
   `--data-mib` of resident data (128 MiB for RS(2,1), as bench.py);
3. the SHEC(6,3,2) single-erasure decode: its cached decode matrix
   chained over 8 MiB chunks (K1);
4. the CLAY(8,4,d=11) single-shard repair: the [64, 176] repair matrix
   chained over ~4 MiB chunks' repair planes (K2), with the repair's
   bytes read as a fraction of a full decode's;
5. the straw2 remap of `--crush-pgs` objects (10M) x 3 replicas over the
   1024-OSD map of 128 hosts x 8 OSDs (K3), in maps/s;

and the traffic column (bench/traffic.py run_scenario: 32 clients of
4 KiB RS(8,4) writes, batched against per-op).  Beside each figure stand
its CPU column (the C++ oracles in native/, on the host: ISA-L-style
split tables for the GF applies, the compiled-C mapper for CRUSH), its
byte bound (the bytes the work must move at 3.35 TB/s, the H100 SXM's
HBM rate) and, on the card, the card's name and power limit.  Every
output is checked byte for byte: each chain against the numpy codec on
column windows (and, on the card, against the plain PyTorch version
over every byte), the remap against the oracle on the oracle's whole
batch.  A failed config raises; there is no partial line.  With
``--device cpu`` the GF work runs the kernels' plain version on the host
clock and the result says so (``"clock": "host"``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM peak HBM bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: the remap's oracle column and its check run on at most this many xs
ORACLE_CAP = 1_000_000
#: columns of each window the numpy codec checks a chain on
CHECK_COLS = 4096


def _card(device) -> dict | None:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"name": smi.split(",")[0].strip(), "power_limit": smi.split(",")[1].strip()}


def _windows(L: int) -> np.ndarray:
    """Column indices the numpy codec checks: the first, middle and last
    CHECK_COLS columns (all of them for a short chunk)."""
    if L <= 3 * CHECK_COLS:
        return np.arange(L)
    mid = L // 2 - CHECK_COLS // 2
    return np.concatenate([np.arange(CHECK_COLS), np.arange(mid, mid + CHECK_COLS),
                           np.arange(L - CHECK_COLS, L)])


def check_chain(mat: np.ndarray, data: np.ndarray, device, iters: int = 2) -> None:
    """Run `iters` chained applies of `mat` over `data` on `device` and
    hold the result against the numpy codec on column windows (a column's
    chain depends on that column alone) and, on the card, against the
    plain PyTorch version over every byte.  Raises on a difference."""
    import torch

    from ..gf.reference_codec import apply_matrix as np_apply
    from ..ops.gf_kernels import apply_matrix_plain
    from .timing import make_chained_encode

    rows = mat.shape[0]
    loop, prep = make_chained_encode(mat, device)
    got = loop(prep(data), iters)
    cols = _windows(data.shape[1])
    ref = np.ascontiguousarray(data[:, cols])
    for _ in range(iters):
        ref[:rows] ^= np_apply(mat, ref)
    if not np.array_equal(got[:, cols].cpu().numpy(), ref):
        raise AssertionError(f"chained {list(mat.shape)} apply differs from the numpy codec")
    if got.device.type == "cuda":
        plain = torch.from_numpy(np.ascontiguousarray(data)).to(got.device)
        for _ in range(iters):
            plain[:rows] ^= apply_matrix_plain(mat, plain)
        if not torch.equal(got, plain):
            raise AssertionError(f"chained {list(mat.shape)} apply differs from the plain version")


def oracle_gibps(mat: np.ndarray, data_mib: int, reps: int = 3) -> float:
    """The C++ oracle's GF apply (native/gf_oracle.cc, ISA-L's split
    tables with AVX2) on the host: input GiB/s over `data_mib` of input
    (bench.py's cpu_baseline_gibps)."""
    from .. import native_oracle

    n = mat.shape[1]
    data = np.random.default_rng(0).integers(0, 256, (n, data_mib * 2**20 // n), dtype=np.uint8)
    native_oracle.encode(mat, data, fast=True)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        native_oracle.encode(mat, data, fast=True)
    return data.nbytes / ((time.perf_counter() - t0) / reps) / 2**30


def chained_gibps(mat: np.ndarray, data: np.ndarray, iters: int, out_bytes: int,
                  device) -> tuple[float, str]:
    """(GiB/s, clock) of `iters` chained applies of `mat` over `data`,
    counting `out_bytes` an iteration (bench.py's method: the marginal
    cost of an iteration, the best of 3)."""
    from .timing import time_chained_encode

    t = time_chained_encode(mat, data, iters, device=device,
                            subtract_overhead=True, repeats=3)
    return out_bytes * iters / t.seconds / 2**30, \
        "cuda_events" if t.device == "cuda" else "host"


def bound_gibps(rows: int, n: int, L: int, out_bytes: int) -> float:
    """GiB/s of `out_bytes` an apply at the byte bound: (n + rows) * L
    bytes moved at HBM_BYTES_PER_S."""
    return out_bytes / ((n + rows) * L / HBM_BYTES_PER_S) / 2**30


def gf_config(number: int, name: str, mat: np.ndarray, data: np.ndarray, iters: int,
              out_bytes: int, cpu_mib: int, device, **extra) -> dict:
    rows, n = mat.shape
    check_chain(mat, data, device)
    gibps, clock = chained_gibps(mat, data, iters, out_bytes, device)
    cpu = oracle_gibps(mat, cpu_mib) * (rows / n if out_bytes != data.nbytes else 1.0)
    return {"config": number, "name": name, "shape": [rows, n, data.shape[1]],
            "gibps": gibps, "clock": clock, "iterations": iters,
            "cpu_oracle_gibps": cpu,
            "bound_gibps": bound_gibps(rows, n, data.shape[1], out_bytes),
            "bytes_equal": True, **extra}


def shec_setup(device):
    """(decode matrix, available chunks) of SHEC(6,3,2)'s local repair of
    chunk 2 (bench.py's _shec_matrix)."""
    from ..ec.registry import ErasureCodePluginRegistry

    codec = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "shec", "k": "6", "m": "3", "c": "2"}, device=device)
    plan = codec.minimum_to_decode({2}, set(range(9)) - {2})
    avail = tuple(sorted(plan))
    M = np.ascontiguousarray(codec._decode_matrix(frozenset({2}), avail), np.uint8)
    return M, avail


def clay_setup(device, chunk_mib: int = 4):
    """(repair matrix, chunk, sub-chunk length, helpers, codec) of
    CLAY(8,4,d=11)'s repair of shard 0 (bench.py's _clay_setup)."""
    from ..ec.registry import ErasureCodePluginRegistry

    codec = ErasureCodePluginRegistry.instance().factory(
        {"plugin": "clay", "k": "8", "m": "4"}, device=device)
    chunk = codec.get_chunk_size(8 * (chunk_mib << 20))
    Z = codec.get_sub_chunk_count()
    helpers = tuple(i for i in range(12) if i != 0)
    M = np.ascontiguousarray(codec.repair_matrix(0, helpers), np.uint8)
    return M, chunk, chunk // Z, helpers, codec


def crush_config(num_pgs: int, device) -> dict:
    """Config 5: the 10M-object x 3 replica remap over 128 hosts x 8
    OSDs through crush_do_rule_batch (K3 on the card), against the C++
    oracle on its capped batch, which must agree with the same prefix."""
    import torch

    from ..crush import CompiledCrushMap, build_hierarchical_map, crush_do_rule_batch
    from ..crush.oracle_bridge import do_rule_batch_oracle

    cmap = build_hierarchical_map(128, 8)
    weights = np.full(1024, 0x10000, dtype=np.uint32)
    xs = np.arange(num_pgs, dtype=np.int64)
    cm = CompiledCrushMap(cmap, device=device)
    crush_do_rule_batch(cm, 0, xs[:1024], 3, weights).cpu()  # build + sync
    t0 = time.perf_counter()
    out = crush_do_rule_batch(cm, 0, xs, 3, weights)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = min(num_pgs, ORACLE_CAP)
    do_rule_batch_oracle(cmap, 0, xs[:1024], 3, weights)  # warm
    t0 = time.perf_counter()
    ref = do_rule_batch_oracle(cmap, 0, xs[:n], 3, weights)
    dt_o = time.perf_counter() - t0
    if not np.array_equal(out[:n].cpu().numpy(), ref):
        raise AssertionError(f"the remap differs from the C++ oracle on its {n} xs")
    # bytes the remap must move: each x read (4 B), each placement written
    moved = num_pgs * (4 + 3 * 4)
    return {"config": 5, "name": "crush_remap_10m", "num_pgs": num_pgs,
            "maps_per_s": num_pgs / dt, "seconds": dt, "clock": "host",
            "cpu_oracle_maps_per_s": n / dt_o, "oracle_checked": n,
            "bound_maps_per_s": num_pgs / (moved / HBM_BYTES_PER_S),
            "bit_exact_vs_oracle": True}


def run(device, data_mib: int = 256, iters: int = 50, crush_pgs: int = 10_000_000,
        traffic_clients: int = 32, traffic_seconds: float = 3.0,
        chunk_mib: int = 8, clay_chunk_mib: int = 4) -> dict:
    """Every config on `device` (cuda unless "cpu" is asked); raises on
    the first failure."""
    from ..common.device import resolve_device
    from ..gf.matrix import cauchy_good_coding_matrix, vandermonde_coding_matrix
    from .traffic import run_scenario

    device = resolve_device(device)

    rng = np.random.default_rng(1)
    configs = []
    coding21 = np.ascontiguousarray(vandermonde_coding_matrix(2, 1), np.uint8)
    d21 = rng.integers(0, 256, (2, max(1, data_mib // 2) * 2**20 // 2), dtype=np.uint8)
    configs.append(gf_config(1, "rs2_1_van_encode", coding21, d21, iters, d21.nbytes,
                             64, device))
    coding84 = np.ascontiguousarray(cauchy_good_coding_matrix(8, 4), np.uint8)
    d84 = np.random.default_rng(1).integers(0, 256, (8, data_mib * 2**20 // 8), dtype=np.uint8)
    configs.append(gf_config(2, "rs8_4_cauchy_good_encode", coding84, d84, iters, d84.nbytes,
                             64, device))
    M, avail = shec_setup(device)
    chunk = chunk_mib << 20
    x = np.random.default_rng(7).integers(0, 256, (len(avail), chunk), dtype=np.uint8)
    configs.append(gf_config(3, "shec_6_3_2_decode1", M, x, iters, chunk,
                             len(avail) * chunk_mib, device, reads_chunks=len(avail)))
    M, chunk, sub_len, helpers, clay = clay_setup(device, clay_chunk_mib)
    need = clay.minimum_to_decode({0}, set(helpers))
    fetched = sum(chunk if ln == -1 else ln * sub_len
                  for ranges in need.values() for _off, ln in ranges)
    x = np.random.default_rng(7).integers(0, 256, (M.shape[1], sub_len), dtype=np.uint8)
    configs.append(gf_config(4, "clay_8_4_repair", M, x, iters, chunk,
                             max(16, M.shape[1] * sub_len >> 20), device,
                             repair_bw_frac_of_naive=fetched / (clay.k * chunk)))
    configs.append(crush_config(crush_pgs, device))
    traffic = run_scenario(n_clients=traffic_clients, seconds=traffic_seconds,
                           write_size=4096, device=device)
    return {"device": str(device), "card": _card(device), "configs": configs,
            "traffic": traffic}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.bench.baseline",
        description="BASELINE.json configs 1-5 and the traffic column, one JSON line")
    ap.add_argument("--device", default="cuda",
                    help="where the codecs and the mapper run (default: cuda)")
    ap.add_argument("--data-mib", type=int, default=256,
                    help="RS(8,4)'s resident data; RS(2,1) takes half (default 256)")
    ap.add_argument("--iters", type=int, default=50, help="chained iterations (default 50)")
    ap.add_argument("--chunk-mib", type=int, default=8,
                    help="SHEC's chunk size (default 8)")
    ap.add_argument("--clay-chunk-mib", type=int, default=4,
                    help="CLAY's chunk size (default ~4)")
    ap.add_argument("--crush-pgs", type=int, default=10_000_000,
                    help="objects the remap maps (default 10M)")
    ap.add_argument("--traffic-clients", type=int, default=32)
    ap.add_argument("--traffic-seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    res = run(args.device, args.data_mib, args.iters, args.crush_pgs, args.traffic_clients,
              args.traffic_seconds, args.chunk_mib, args.clay_chunk_mib)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
