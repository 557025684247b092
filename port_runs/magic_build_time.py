#!/usr/bin/env python3
"""What K3's magic tables cost to build on the host, for the 1024-OSD map.

    python3 port_runs/magic_build_time.py      (from the repo root; CPU only)

Times ``crush_kernels.straw2_magic`` (the port's ``magic_tables`` by
distinct weight value, M joined into one word, k and a packed) and the
reference's per-entry ``ceph_tpu.crush.magic_div.magic_tables`` on the
[129, 128] weight table of the 128-host x 8-OSD map (BASELINE config
5), and prints the medians in ms beside the host's processor name.
"""
from __future__ import annotations

import platform
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ceph_tpu.crush.magic_div import magic_tables as reference_tables  # noqa: E402
from ceph_tpu_torch.crush import build_hierarchical_map  # noqa: E402
from ceph_tpu_torch.crush.mapper import CompiledCrushMap  # noqa: E402
from ceph_tpu_torch.ops.crush_kernels import straw2_magic  # noqa: E402


def median_ms(fn, n: int) -> float:
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main() -> int:
    weights = CompiledCrushMap(build_hierarchical_map(128, 8), device="cpu").weights.numpy()
    port = median_ms(lambda: straw2_magic(weights), 200)
    ref = median_ms(lambda: reference_tables(weights), 20)
    print(f"{weights.shape} weights, {np.unique(weights).size} distinct: port straw2_magic "
          f"{port:.3f} ms, reference magic_tables {ref:.3f} ms "
          f"({platform.processor() or platform.machine()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
