#!/usr/bin/env python3
"""K2 against other builds of csrc/gf_apply.cu, in turns, on one card.

    python3 port_runs/k2_turns.py [--old OLD.cu] [--variants nf4]

Times ceph_tpu_torch's gf_apply_k2 at the two CLAY repair shapes of
chip_smoke.py (CLAY(8,4,d=11) [64, 176] x 65,536 and CLAY(12,4,d=15)
[256, 960] x 16,384) beside:

  * ``--old``: another gf_apply.cu whose gf_apply_k2_launch takes the
    split-nibble tables and a (band_rows, chunk_rows) layout, as the
    source of commit 9166054 does
    (``git show 9166054:ceph_tpu_torch/csrc/gf_apply.cu > old.cu``);
  * ``--variants``: the package's own source with constants changed
    (``VARIANTS``), built beside it.

Every build's output is held to apply_matrix_plain first.  Then each is
timed (median of 30 launches, CUDA events) in turns, forward and back
(old, new, variants..., variants..., new, old), so that each pair shares
one card and one stretch of time.  It prints the card's name and power
limit, each build's ptxas registers and spills, and the instructions of
each new-form K2's k-step loop per IMMA in its SASS (cuobjdump).  Needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its SASS parser)
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry  # noqa: E402
from ceph_tpu_torch.ops import gf_kernels as gk  # noqa: E402
from ceph_tpu_torch.ops.nvcc import NVCC_FLAGS, nvcc  # noqa: E402

BUILD = ROOT / "build" / "k2_turns"
#: name -> (text in csrc/gf_apply.cu, replacement)
VARIANTS = {
    # the 64 x 32 warp tile: 4 n8 fragments a warp in at most 128
    # registers, 4 blocks of 4 warps an SM
    "nf4": [("constexpr int K2_NFRAG = 8;", "constexpr int K2_NFRAG = 4;"),
            ("__launch_bounds__(K2_THREADS, 2)", "__launch_bounds__(K2_THREADS, 4)")],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build(src: Path, out: Path) -> ctypes.CDLL:
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src.name}: {proc.stdout}{proc.stderr}")
    k2 = False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            k2 = "gf_apply_k2" in line
        elif k2 and ("registers" in line or "spill" in line):
            log(f"    ptxas {src.name} gf_apply_k2: {line.strip()}")
    return ctypes.CDLL(str(out))


def loop_per_imma(label: str, library: Path) -> None:
    sass = subprocess.run([str(Path(nvcc()).parent / "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    for name, code in chip_smoke.sass_functions(sass).items():
        if "gf_apply_k2" not in name:
            continue
        # the innermost loop that holds IMMA: the unrolled k-steps
        loops = [(chip_smoke.branch_target(i), a) for a, i in code
                 if chip_smoke.opcode(i) == "BRA" and chip_smoke.branch_target(i) < a]
        bodies = [chip_smoke.between(code, lo, hi) for lo, hi in loops]
        body = min((b for b in bodies if any(chip_smoke.opcode(i) == "IMMA" for i in b)),
                   key=len)
        ops = collections.Counter(chip_smoke.opcode(i) for i in body)
        log(f"    sass {label} k-step loop: {sum(ops.values())} instructions, "
            f"{ops['IMMA']} IMMA ({sum(ops.values()) / max(ops['IMMA'], 1):.2f} per IMMA); "
            f"{dict(ops.most_common())}")


def time_ms(fn, iters: int = 30) -> float:
    """Median device ms of `fn` by the port's one timer
    (ceph_tpu_torch/bench/timing.py)."""
    from ceph_tpu_torch.bench.timing import time_ms as timer

    return timer(torch, fn, iters, warmup=3)[0]


def old_tables(mat: np.ndarray) -> np.ndarray:
    """The split-nibble tables commit 9166054's K2 reads, [rows, n, 32]:
    lo[x] = c*x and hi[x] = c*(x << 4) for x in 0..15."""
    from ceph_tpu_torch.gf.tables import GF_MUL_TABLE

    x = np.arange(16, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.uint8)[:, :, None]
    return np.ascontiguousarray(np.concatenate(
        [GF_MUL_TABLE[mat, x[None, None]], GF_MUL_TABLE[mat, (x << 4)[None, None]]], axis=2))


def old_layout(rows: int, n: int) -> tuple[int, int]:
    """(band_rows, chunk_rows) as commit 9166054's gf_kernels.k2_layout."""
    band = min(rows, 16)
    cap = gk.SMEM_PER_BLOCK // (32 * band + 4 * 128)
    chunks = -(-n // cap)
    return band, -(-n // chunks)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="a gf_apply.cu with the tables ABI")
    ap.add_argument("--variants", default="", help=f"comma list of {sorted(VARIANTS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_turns: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    BUILD.mkdir(parents=True, exist_ok=True)
    names = [v for v in args.variants.split(",") if v]
    source = gk.LIBRARY.source.read_text()
    jobs = {}
    for v in names:
        text = source
        for a, b in VARIANTS[v]:
            if a not in text:
                raise ValueError(f"variant {v}: {a!r} not in {gk.LIBRARY.source.name}")
            text = text.replace(a, b)
        jobs[v] = BUILD / f"gf_apply_{v}.cu"
        jobs[v].write_text(text)
    if args.old:
        jobs["old"] = args.old
    libs, errors = {}, []

    def run(key, src):
        try:
            libs[key] = build(src, BUILD / f"lib_{key}.so")
        except Exception as e:  # raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    threads.append(threading.Thread(target=gk.library))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for line in gk.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas gf_apply.cu: {line.strip()}")
    loop_per_imma("new", gk.LIBRARY.path())
    for v in names:
        loop_per_imma(v, BUILD / f"lib_{v}.so")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for key, lib in libs.items():
        lib.gf_apply_k2_launch.restype = i
        lib.gf_apply_k2_launch.argtypes = ([p, i, i, i, i, p, i, ll, p, ll, p] if key == "old"
                                           else [p, i, i, i, p, i, ll, p, ll, p])

    dev = torch.device("cuda")
    reg = ErasureCodePluginRegistry.instance()
    shapes = (
        ("CLAY(8,4,d=11) repair", reg.factory({"plugin": "clay", "k": "8", "m": "4"}
                                              ).repair_matrix(0, tuple(range(1, 12))), 65536),
        ("CLAY(12,4,d=15) repair", reg.factory({"plugin": "clay", "k": "12", "m": "4", "d": "15"}
                                               ).repair_matrix(0, tuple(range(1, 16))), 16384),
    )
    g = torch.Generator(device=dev)
    g.manual_seed(20261017)
    for name, mat, L in shapes:
        rows, n = mat.shape
        x = torch.randint(0, 256, (n, L), dtype=torch.uint8, device=dev, generator=g)
        plain = gk.apply_matrix_plain(mat, x)
        desc = torch.tensor([[x.data_ptr(), x.stride(0), L, 0]], dtype=torch.int64, device=dev)
        op = torch.from_numpy(gk.k2_operand(mat)).to(dev)
        tables = torch.from_numpy(old_tables(mat)).to(dev)
        runs = {"new": gk.prepare(mat, [x], op)}
        outs = {"new": runs["new"].out}
        for key, lib in libs.items():
            out = torch.empty((rows, L), dtype=torch.uint8, device=dev)
            head = ((tables.data_ptr(), rows, n, *old_layout(rows, n)) if key == "old"
                    else (op.data_ptr(), rows, n, op.shape[1]))

            def launch(lib=lib, head=head, out=out):
                rc = lib.gf_apply_k2_launch(*head, desc.data_ptr(), 1, L, out.data_ptr(), L,
                                            torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            runs[key], outs[key] = launch, out
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        same = {k: torch.equal(o, plain) for k, o in outs.items()}
        log(f"{name} [{rows}, {n}] x {L}: equal to the plain version {same}")
        if not all(same.values()):
            return 1
        order = (["old"] if "old" in runs else []) + ["new"] + names
        times = collections.defaultdict(list)
        for key in order + order[::-1]:
            times[key].append(time_ms(runs[key]))
        log(f"    turns (ms, forward and back): {dict(times)}")
        log(f"    bound {(n + rows) * L / chip_smoke.HBM_BYTES_PER_S * 1e3:.4f} ms by bytes, "
            f"tensor-core floor {chip_smoke.tc_floor_ms(rows, n, L):.4f} ms; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
