"""Device compute of the port: the GF(2^8) apply seam (bitplane.py), the
hand-written CUDA kernels (gf_kernels.py over csrc/gf_apply.cu,
crush_kernels.py over csrc/crush_straw2.cu) and their shared nvcc
builder (nvcc.py)."""
