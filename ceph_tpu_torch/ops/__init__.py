"""Device compute of the port: the GF(2^8) apply seam (bitplane.py) and
its hand-written CUDA kernels (gf_kernels.py, csrc/gf_apply.cu)."""
