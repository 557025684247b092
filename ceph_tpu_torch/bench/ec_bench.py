"""ceph_erasure_code_benchmark-compatible CLI (the port's counterpart of
ceph_tpu/bench/ec_bench.py).

Re-creation of the reference's benchmark harness (reference:
src/test/erasure-code/ceph_erasure_code_benchmark.cc :: ErasureCodeBench —
flags --plugin/--parameter/--workload/--size/--iterations/--erasures/
--erasures-generation; prints seconds and bytes), so BASELINE numbers are
produced by a CLI-compatible tool (SURVEY.md §3.5 "the contract for BASELINE
measurements").

Extra over the reference: `--json` emits one machine-readable line, and
`--device` names where the codec runs (``cuda`` by default; without a card
it raises; ``cpu`` on request runs the kernels' plain version).  On the card
encode and rmw chain their iterations (each consumes the previous result,
so nothing is elided; see bench/timing.py) and time them with CUDA events:
device time.  --no-chain times the reference's loop of codec calls on the
host clock instead; decode always does.  The JSON names the clock
("clock": "cuda_events" or "host").

Usage example (BASELINE.json config 2):
    python -m ceph_tpu_torch.bench.ec_bench encode --plugin torch \
        --parameter k=8 --parameter m=4 --parameter technique=cauchy_good \
        --size 1048576 --iterations 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..ec.registry import ErasureCodePluginRegistry

#: the last run's result, outputs included (the stream's parity, the
#: decode's chunks and erasure patterns), for callers that check bytes
LAST_RESULT: dict = {}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="ceph_tpu_torch.bench.ec_bench")
    p.add_argument("workload", choices=["encode", "decode", "rmw"])
    p.add_argument("--plugin", "-P", default="torch")
    p.add_argument("--device", default="cuda",
                   help="the codec's device (default: cuda; cpu on request)")
    p.add_argument(
        "--parameter",
        "-p",
        action="append",
        default=[],
        help="profile key=value (repeatable), e.g. -p k=8 -p m=4",
    )
    p.add_argument("--size", "-s", type=int, default=1 << 20, help="object bytes per iteration")
    p.add_argument("--iterations", "-i", type=int, default=16)
    p.add_argument("--erasures", "-e", type=int, default=1)
    p.add_argument(
        "--erasures-generation",
        choices=["random", "exhaustive"],
        default="random",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--no-chain", action="store_true", help="per-iteration dispatch")
    p.add_argument(
        "--stream", type=int, default=0, metavar="N",
        help="encode N fresh host batches double-buffered (DMA/compute "
        "overlap) instead of chained device-resident iterations",
    )
    p.add_argument(
        "--rmw-width", type=int, default=4096, metavar="BYTES",
        help="rmw workload: bytes of the sub-stripe update window",
    )
    return p.parse_args(argv)


def build_codec(args):
    profile = {"plugin": args.plugin}
    for kv in args.parameter:
        key, _, val = kv.partition("=")
        profile[key] = val
    return ErasureCodePluginRegistry.instance().factory(
        profile, device=args.device), profile


def _chained(codec, args) -> bool:
    """Whether the codec's encodes take the chained device timer: a
    byte-matrix codec on the torch backend (bitmatrix techniques and host
    backends take the timed loop of codec calls)."""
    return (getattr(codec, "backend", None) == "torch"
            and getattr(codec, "coding", None) is not None
            and not args.no_chain)


def _host_loop(fn, iterations: int) -> dict:
    """The reference's loop of codec calls on the host clock; a call's
    device work is finished before the clock stops (the codec returns a
    tensor on its device)."""
    _sync(fn())  # warm
    t0 = time.perf_counter()
    out = None
    for _ in range(iterations):
        out = fn()
    _sync(out)
    return {"seconds": time.perf_counter() - t0, "clock": "host"}


def _sync(out) -> None:
    import torch

    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def run_encode(codec, args) -> dict:
    from .timing import time_chained_encode

    rng = np.random.default_rng(args.seed)
    chunk_size = codec.get_chunk_size(args.size)
    chunks = rng.integers(0, 256, (codec.k, chunk_size), dtype=np.uint8)
    if args.stream:
        # end-to-end streaming throughput INCLUDING host->device DMA,
        # double-buffered (ops/pipeline.py); distinct fresh batches so
        # nothing is cached away
        if getattr(codec, "coding", None) is None or \
                getattr(codec, "backend", None) != "torch":
            raise SystemExit(
                "--stream needs a byte-matrix codec on the torch backend "
                "(bitmatrix techniques / host backends use the default "
                "timing paths)"
            )
        from ..ops.pipeline import stream_encode

        batches = [
            rng.integers(0, 256, (codec.k, chunk_size), dtype=np.uint8)
            for _ in range(args.stream)
        ]
        stream_encode(codec.coding, batches[:1], codec.device)  # warm/build
        t0 = time.perf_counter()
        parity = stream_encode(codec.coding, batches, codec.device)
        seconds = time.perf_counter() - t0
        return {"seconds": seconds, "bytes": args.size * args.stream,
                "clock": "host", "parity": parity}
    if _chained(codec, args):
        t = time_chained_encode(codec.coding, chunks, args.iterations,
                                device=codec.device)
        res = {"seconds": t.seconds,
               "clock": "cuda_events" if t.device == "cuda" else "host"}
    else:
        res = _host_loop(lambda: codec.encode_chunks(chunks), args.iterations)
    res["bytes"] = args.size * args.iterations
    return res


def run_rmw(codec, args) -> dict:
    """Partial-stripe RMW parity-delta workload: each iteration is the
    device-side cost of one OSD ranged write — the parity delta for a
    --rmw-width byte sub-stripe update, i.e. one GF matrix apply over
    just the touched column window (reference: the re-encode inside
    src/osd/ECTransaction.cc :: generate_transactions, expressed as the
    optimized-EC parity-delta; mirrors OSD._ec_rmw).  Reported bytes are
    the UPDATED user bytes, so GiB/s is directly comparable to what a
    full-stripe re-encode of the same update would cost."""
    from .timing import time_chained_encode

    rng = np.random.default_rng(args.seed)
    w = args.rmw_width
    W = codec.get_chunk_size(codec.k * w)
    delta = rng.integers(0, 256, (codec.k, W), dtype=np.uint8)
    if _chained(codec, args):
        t = time_chained_encode(codec.coding, delta, args.iterations,
                                device=codec.device)
        res = {"seconds": t.seconds,
               "clock": "cuda_events" if t.device == "cuda" else "host"}
    else:
        res = _host_loop(lambda: codec.encode_chunks(delta), args.iterations)
    res.update(bytes=w * args.iterations, ops=args.iterations)
    return res


def run_decode(codec, args) -> dict:
    import itertools

    rng = np.random.default_rng(args.seed)
    k, m, n = codec.k, codec.m, codec.get_chunk_count()
    chunk_size = codec.get_chunk_size(args.size)
    data = rng.integers(0, 256, (k, chunk_size), dtype=np.uint8)
    encoded = codec.encode(set(range(n)), data.tobytes())
    if args.erasures > m:
        raise SystemExit(f"--erasures {args.erasures} > m={m}")
    if args.erasures_generation == "exhaustive":
        patterns = itertools.cycle(
            itertools.combinations(range(n), args.erasures)
        )
    else:
        patterns = iter(
            lambda: tuple(rng.choice(n, size=args.erasures, replace=False)), None
        )
    want = set(range(k))
    erasures = []
    out = None
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        erased = set(int(x) for x in next(patterns))
        erasures.append(sorted(erased))
        have = {i: c for i, c in encoded.items() if i not in erased}
        out = codec.decode(want, have, chunk_size)
    _sync(next(iter(out.values())) if out else None)
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "bytes": args.size * args.iterations,
            "clock": "host", "erasures": erasures, "decoded": out}


def main(argv=None):
    from ..common.device import resolve_device
    from ..common.tracer import device_trace as _device_trace
    args = parse_args(argv)
    resolve_device(args.device)  # raises without a card unless --device cpu
    codec, profile = build_codec(args)
    with _device_trace():  # armed by CEPH_TPU_PROFILE=<logdir>
        runner = {"encode": run_encode, "decode": run_decode,
                  "rmw": run_rmw}[args.workload]
        res = runner(codec, args)
    LAST_RESULT.clear()
    LAST_RESULT.update(res)
    gibps = res["bytes"] / max(res["seconds"], 1e-12) / 2**30
    if args.json:
        print(
            json.dumps(
                {
                    "workload": args.workload,
                    "profile": profile,
                    "device": str(codec.device),
                    "clock": res["clock"],
                    "seconds": round(res["seconds"], 6),
                    "bytes": res["bytes"],
                    "GiB_per_s": round(gibps, 3),
                }
            )
        )
    else:
        # reference output shape: "<seconds>\t<bytes>"
        print(f"{res['seconds']:.6f}\t{res['bytes']}")
        print(f"# {gibps:.2f} GiB/s {args.workload} plugin={args.plugin} "
              f"device={codec.device} clock={res['clock']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
