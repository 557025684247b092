"""Benchmark CLIs: ec_bench (ceph_erasure_code_benchmark analog),
crush_bench, traffic, and baseline (BASELINE.json configs 1-5 on the
card)."""
