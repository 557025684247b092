"""Shared device timing for the port's benchmarks (the counterpart of
ceph_tpu/bench/timing.py).

One timer, ``time_ms``: CUDA events around each call, with the stream
held (``torch.cuda._sleep``) until the host has enqueued every timed
call, so the events bracket the device's work alone and not the
wrapper's host work.  ``time_chained_encode`` times a dependent chain of
encodes the same way: each iteration XORs the parity into the first rows
of its input, so no launch can be elided, and every launch of the chain
is enqueued before the first event runs.  On the card each iteration is
one K1 or K2 launch (``gf_kernels.prepare``, the route ``ops/bitplane``
takes, ``kernel_for`` choosing); with ``device="cpu"`` it is the
kernels' plain PyTorch version on the host clock, and the result says
``cpu``.  The chain moves only the caller's bytes: K1 needs no padding.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

#: GPU clock cycles torch.cuda._sleep spins for a millisecond's hold (at
#: the H100's 1980 MHz boost, or longer at a lower clock), and the longest hold
SLEEP_CYCLES_PER_MS = 2_000_000
MAX_HOLD_MS = 3000.0


def time_ms(torch, fn, iters: int, warmup: int = 2, label: str | None = None
            ) -> tuple[float, float]:
    """(device ms, host ms) of one call: the median over `iters` calls of
    the CUDA events around each call, and of time.perf_counter around it.

    A torch.cuda._sleep ahead of the first event holds the stream until
    the host has enqueued every timed call (twice the last warm-up's host
    time each, and a millisecond), so the events bracket the device's work
    alone and not the wrapper's host work; the host time is printed on its
    own line when `label` is given."""
    host_s = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    hold(torch, iters * host_s)
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
        print(f"    host time of {label}: {host_ms:.4f} ms per call (device {dev_ms:.4f} ms)",
              flush=True)
    return dev_ms, host_ms


def hold(torch, host_s: float) -> None:
    """Hold the current stream for twice `host_s` of host enqueueing and
    a millisecond (at most MAX_HOLD_MS)."""
    hold_ms = min(2 * host_s * 1e3 + 1.0, MAX_HOLD_MS)
    torch.cuda._sleep(int(hold_ms * SLEEP_CYCLES_PER_MS))


class ChainTime(NamedTuple):
    """A chained encode's time and the clock that took it: ``cuda``
    (CUDA events, device time) or ``cpu`` (the host clock around the
    plain version)."""

    seconds: float
    device: str


def make_chained_encode(coding: np.ndarray, device=None):
    """(loop, prep): ``prep(chunks)`` copies a [n, L] host array to the
    device; ``loop(x, iters)`` runs `iters` dependent encodes of it in
    place (x[:rows] ^= coding · x, rows <= n) and returns x.  On a CUDA
    device each iteration is one launch of the kernel ``kernel_for``
    picks, staged once; on the CPU it is the plain version."""
    import torch

    from ..common.device import resolve_device
    from ..ops import gf_kernels

    coding = np.ascontiguousarray(coding, dtype=np.uint8)
    rows, n = coding.shape
    if rows > n:
        raise ValueError("a chained encode needs rows <= n")
    dev = resolve_device(device)

    def prep(chunks: np.ndarray) -> torch.Tensor:
        # a copy on either device: the chain runs in place
        t = torch.from_numpy(np.ascontiguousarray(chunks, dtype=np.uint8))
        return t.clone() if dev.type == "cpu" else t.to(dev)

    if dev.type == "cpu":
        def loop(x: torch.Tensor, iters: int) -> torch.Tensor:
            for _ in range(iters):
                x[:rows] ^= gf_kernels.gf_apply(coding, [x])
            return x
        return loop, prep

    staged: dict[int, tuple] = {}

    def loop(x: torch.Tensor, iters: int) -> torch.Tensor:
        # one staged launch per input tensor: its output is reused by
        # every iteration, and the XOR makes each launch read the last
        key = x.data_ptr()
        if key not in staged:
            staged.clear()
            staged[key] = (gf_kernels.prepare(coding, [x]), x[:rows])
        launch, head = staged[key]
        for _ in range(iters):
            head ^= launch()
        return x

    return loop, prep


def time_chained_encode(
    coding: np.ndarray, chunks: np.ndarray, iterations: int, device=None,
    subtract_overhead: bool = False, repeats: int = 1,
) -> ChainTime:
    """The time of `iterations` chained encodes of chunks [n, L].

    On the card: CUDA events around the chain, the stream held until
    every launch is enqueued (device time).  On the CPU: the host clock
    around the plain version.  subtract_overhead: time a 1-iteration
    chain too and return (t_N - t_1) / (N - 1) * N, the marginal cost of
    an iteration (bench.py's headline method), unless t_N does not
    clearly exceed t_1; otherwise the chain's whole time.  The best of
    `repeats`."""
    import torch

    loop, prep = make_chained_encode(coding, device)
    x = prep(np.asarray(chunks))
    on_card = x.device.type == "cuda"

    def run(iters: int) -> float:
        if not on_card:
            t0 = time.perf_counter()
            loop(x, iters)
            return time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(x, 1)
        one_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        hold(torch, iters * one_s)
        a.record()
        loop(x, iters)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) * 1e-3

    run(1)  # build, stage and warm outside the timed region
    best_t1 = best_tN = float("inf")
    for _ in range(max(1, repeats)):
        if subtract_overhead:
            best_t1 = min(best_t1, run(1))
        best_tN = min(best_tN, run(iterations))
    if subtract_overhead and iterations > 1 and best_tN > best_t1 * 1.05:
        seconds = (best_tN - best_t1) / (iterations - 1) * iterations
    else:
        seconds = best_tN
    return ChainTime(seconds, x.device.type)
