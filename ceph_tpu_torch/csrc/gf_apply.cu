// GF(2^8) matrix apply on Hopper: out[rows, L] = mat[rows, n] x in[n, L].
//
// Replaces the two Pallas kernels of ceph_tpu/ops/pallas_gf.py:
//   gf_apply_k1  <- _apply_kernel          (pallas_gf.py:184, rb == 1)
//   gf_apply_k2  <- _apply_kernel_blocked  (pallas_gf.py:202, rb > 1)
//
// What bounds it.  The apply reads n*L bytes and writes rows*L bytes; for
// the RS encode and decode shapes that is the whole cost on this card
// (3.35 TB/s), so both kernels read each input byte from device memory
// once and write each output byte once.  The TPU kernel's G row grouping,
// VMEM model and bf16 pack-by-matmul are TPU layout and are not carried
// over.
//
// Design: split-nibble multiply tables (ISA-L's form).  For a matrix entry
// c the 32-byte table holds lo[x] = c*x and hi[x] = c*(x << 4) for the 16
// nibble values x, so c*b = lo[b & 15] ^ hi[b >> 4].  A thread owns one
// 32-bit word (4 byte columns) of every input row; one nibble lookup for
// all 4 bytes is two __byte_perm over the table's two 8-byte halves and a
// byte select on the nibble's top bit.  The tables sit in shared memory and
// every thread of a warp reads the same entry (a broadcast), so the
// lookups cost no bank conflicts.
//
//   K1 holds the tables of the whole matrix in one block's shared memory
//   (the host sends a matrix here when rows <= MAX_ROWS and the tables fit
//   K1_MAX_TABLE_BYTES, see ops/gf_kernels.py).  Each block walks a column
//   tile of all n input rows and writes all rows output rows.  A thread
//   owns 16 byte columns (four words, one 16-byte load per row) and
//   issues the next row's load before the current row's lookups, so that
//   enough bytes are in flight to cover the memory latency.
//
//   K2 is the banded form for fat matrices (CLAY repair [64, 176] needs
//   ~360 KB of tables).  A block stages its column tile of the n inputs in
//   shared memory once, then loops over row bands: it loads one band's
//   tables, and writes that band's output rows.  The last band may be
//   short; its missing rows are never computed or stored.  When the tile
//   of all n inputs does not fit beside a band's tables (n above
//   ~227, e.g. CLAY(12,4,d=15) repair [256, 960]), the inputs go through
//   in chunks of chunk_rows: for each band, each chunk's inputs and that
//   chunk's slice of the band's tables are staged in turn, and the band's
//   sums stay in registers across the chunks.  The inputs are then read
//   once per band (through L2) instead of once.
//
// Several input segments (the stripes of a fused flush) go through one
// launch: segment s is [n, len_s] at its own pointer and row stride and
// lands at output columns [out_col_s, out_col_s + len_s).  Ragged lengths
// and unaligned rows are masked in the kernel; the host pads nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K1_THREADS = 256;
constexpr int K1_VECS_PER_THREAD = 2;  // 16-byte vectors: 8192 byte columns per block
constexpr int K2_THREADS = 128;         // 512 byte columns per block

// One segment descriptor is four int64: input pointer, input row stride
// (bytes), length (bytes), first output column.
struct Segment {
  const uint8_t* in;
  long long stride;
  long long len;
  long long out_col;
};

__device__ __forceinline__ Segment load_segment(const long long* segs, int s) {
  Segment g;
  g.in = reinterpret_cast<const uint8_t*>(segs[4 * s]);
  g.stride = segs[4 * s + 1];
  g.len = segs[4 * s + 2];
  g.out_col = segs[4 * s + 3];
  return g;
}

__device__ __forceinline__ bool words_aligned(const Segment& g, const uint8_t* out,
                                              long long out_stride) {
  return (reinterpret_cast<uintptr_t>(g.in) & 3) == 0 && (g.stride & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(out) & 3) == 0 && (out_stride & 3) == 0 &&
         (g.out_col & 3) == 0;
}

__device__ __forceinline__ bool vecs_aligned(const Segment& g, const uint8_t* out,
                                             long long out_stride) {
  return (reinterpret_cast<uintptr_t>(g.in) & 15) == 0 && (g.stride & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(out) & 15) == 0 && (out_stride & 15) == 0 &&
         (g.out_col & 15) == 0;
}

// Bytes [c, c+4) of a row as one little-endian word; bytes past len read 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, long long c,
                                              long long len, bool aligned) {
  if (aligned && c + 4 <= len) return *reinterpret_cast<const uint32_t*>(row + c);
  uint32_t x = 0;
  for (int b = 0; b < 4; ++b)
    if (c + b < len) x |= static_cast<uint32_t>(row[c + b]) << (8 * b);
  return x;
}

__device__ __forceinline__ void store_word(uint8_t* row, long long c, long long len,
                                           bool aligned, uint32_t v) {
  if (aligned && c + 4 <= len) {
    *reinterpret_cast<uint32_t*>(row + c) = v;
    return;
  }
  for (int b = 0; b < 4; ++b)
    if (c + b < len) row[c + b] = static_cast<uint8_t>(v >> (8 * b));
}

// Bytes [c, c+16) of a row as four words; bytes past len read 0.
struct Vec {
  uint32_t w[4];
};

__device__ __forceinline__ Vec load_vec(const uint8_t* row, long long c, long long len,
                                        bool aligned16, bool aligned4) {
  Vec v;
  if (aligned16 && c + 16 <= len) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + c);
    v.w[0] = q.x; v.w[1] = q.y; v.w[2] = q.z; v.w[3] = q.w;
    return v;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v.w[k] = load_word(row, c + 4 * k, len, aligned4);
  return v;
}

__device__ __forceinline__ void store_vec(uint8_t* row, long long c, long long len,
                                          bool aligned16, bool aligned4, const uint32_t (&v)[4]) {
  if (aligned16 && c + 16 <= len) {
    *reinterpret_cast<uint4*>(row + c) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) store_word(row, c + 4 * k, len, aligned4, v[k]);
}

// Bytes y0..y3 (each < 8) -> __byte_perm selector nibbles at bits 0/4/8/12.
__device__ __forceinline__ uint32_t pack_selector(uint32_t y) {
  uint32_t t = y | (y >> 4);
  return (t & 0xFFu) | ((t >> 8) & 0xFF00u);
}

// The four nibble lookups' operands for one input word.
struct Nibbles {
  uint32_t sel_lo, top_lo, sel_hi, top_hi;
};

__device__ __forceinline__ Nibbles split_word(uint32_t x) {
  Nibbles r;
  r.sel_lo = pack_selector(x & 0x07070707u);
  r.sel_hi = pack_selector((x >> 4) & 0x07070707u);
  // 0xFF in each byte whose nibble is >= 8 (entry in the table's top half)
  r.top_lo = ((x >> 3) & 0x01010101u) * 0xFFu;
  r.top_hi = ((x >> 7) & 0x01010101u) * 0xFFu;
  return r;
}

// 16-entry byte table t, looked up at 4 nibbles at once.
__device__ __forceinline__ uint32_t lookup(const uint4& t, uint32_t sel, uint32_t top) {
  uint32_t a = __byte_perm(t.x, t.y, sel);  // entries 0..7
  uint32_t b = __byte_perm(t.z, t.w, sel);  // entries 8..15
  return (a & ~top) | (b & top);
}

// acc[i] ^= mat[r0 + i, j] * x for the band's rows; tab points at the
// band's first row, entry (i, j) at tab[2 * (i * n + j)].
template <int MAXR>
__device__ __forceinline__ void mul_add_rows(uint32_t (&acc)[MAXR], const uint4* tab,
                                             int n, int j, int nrows, uint32_t x) {
  const Nibbles nb = split_word(x);
  const uint4* tj = tab + 2 * j;
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    if (i < nrows) {
      const uint4 lo = tj[2 * n * i];
      const uint4 hi = tj[2 * n * i + 1];
      acc[i] ^= lookup(lo, nb.sel_lo, nb.top_lo) ^ lookup(hi, nb.sel_hi, nb.top_hi);
    }
  }
}

// The same for four words at once: each table entry is read once for all
// four.
template <int MAXR>
__device__ __forceinline__ void mul_add_rows4(uint32_t (&acc)[MAXR][4], const uint4* tab,
                                              int n, int j, int nrows, const Vec& x) {
  Nibbles nb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) nb[k] = split_word(x.w[k]);
  const uint4* tj = tab + 2 * j;
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    if (i < nrows) {
      const uint4 lo = tj[2 * n * i];
      const uint4 hi = tj[2 * n * i + 1];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[i][k] ^= lookup(lo, nb[k].sel_lo, nb[k].top_lo) ^
                     lookup(hi, nb[k].sel_hi, nb[k].top_hi);
    }
  }
}

template <int MAXR>
__global__ void __launch_bounds__(K1_THREADS)
gf_apply_k1(const uint4* __restrict__ tables, int rows, int n,
            const long long* __restrict__ segs, uint8_t* __restrict__ out,
            long long out_stride) {
  extern __shared__ uint4 tab[];  // rows * n * 2
  const Segment g = load_segment(segs, blockIdx.y);
  const long long tile0 =
      static_cast<long long>(blockIdx.x) * (K1_THREADS * K1_VECS_PER_THREAD * 16);
  if (tile0 >= g.len) return;  // whole block: this segment is shorter
  for (int t = threadIdx.x; t < rows * n * 2; t += K1_THREADS) tab[t] = tables[t];
  __syncthreads();
  const bool a4 = words_aligned(g, out, out_stride);
  const bool a16 = vecs_aligned(g, out, out_stride);
  uint8_t* out_seg = out + g.out_col;
  for (int v = 0; v < K1_VECS_PER_THREAD; ++v) {
    const long long c = tile0 + 16LL * (v * K1_THREADS + threadIdx.x);
    if (c >= g.len) break;
    uint32_t acc[MAXR][4];
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0;
    Vec x = load_vec(g.in, c, g.len, a16, a4);
    for (int j = 0; j < n; ++j) {
      Vec next = x;
      if (j + 1 < n) next = load_vec(g.in + (j + 1) * g.stride, c, g.len, a16, a4);
      mul_add_rows4<MAXR>(acc, tab, n, j, rows, x);
      x = next;
    }
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
      if (i < rows) store_vec(out_seg + i * out_stride, c, g.len, a16, a4, acc[i]);
  }
}

// Rows [j0, j0 + nj) of the column tile into xs[jj * K2_THREADS + lane];
// bytes past the segment's end read 0.
__device__ __forceinline__ void stage_inputs(uint32_t* xs, const Segment& g, int j0, int nj,
                                             long long c, bool live, bool aligned) {
  for (int jj = 0; jj < nj; ++jj)
    xs[jj * K2_THREADS + threadIdx.x] =
        live ? load_word(g.in + (j0 + jj) * g.stride, c, g.len, aligned) : 0u;
}

template <int MAXR>
__global__ void __launch_bounds__(K2_THREADS)
gf_apply_k2(const uint4* __restrict__ tables, int rows, int n, int band_rows,
            int chunk_rows, const long long* __restrict__ segs, uint8_t* __restrict__ out,
            long long out_stride) {
  extern __shared__ uint4 smem[];
  uint4* tab = smem;                                         // band_rows*chunk_rows*2
  uint32_t* xs =
      reinterpret_cast<uint32_t*>(smem + band_rows * chunk_rows * 2);  // chunk_rows*K2_THREADS
  const Segment g = load_segment(segs, blockIdx.y);
  const long long tile0 = static_cast<long long>(blockIdx.x) * (K2_THREADS * 4);
  if (tile0 >= g.len) return;
  const bool aligned = words_aligned(g, out, out_stride);
  const long long c = tile0 + 4LL * threadIdx.x;
  const bool live = c < g.len;
  // one chunk: the column tile of all n inputs, read from device memory once
  const bool one_chunk = chunk_rows >= n;
  if (one_chunk) stage_inputs(xs, g, 0, n, c, live, aligned);
  uint8_t* out_seg = out + g.out_col;
  for (int r0 = 0; r0 < rows; r0 += band_rows) {
    const int nrows = min(band_rows, rows - r0);
    uint32_t acc[MAXR];
#pragma unroll
    for (int i = 0; i < MAXR; ++i) acc[i] = 0;
    for (int j0 = 0; j0 < n; j0 += chunk_rows) {
      const int nj = min(chunk_rows, n - j0);
      __syncthreads();  // the previous chunk's tables and inputs are no longer read
      if (!one_chunk) stage_inputs(xs, g, j0, nj, c, live, aligned);
      // entry (i, jj) of the chunk's tables at tab[2 * (i * nj + jj)]
      for (int t = threadIdx.x; t < nrows * nj * 2; t += K2_THREADS) {
        const int i = t / (2 * nj);
        tab[t] = tables[2LL * ((r0 + i) * static_cast<long long>(n) + j0) + (t - i * 2 * nj)];
      }
      __syncthreads();
      if (live)
        for (int jj = 0; jj < nj; ++jj)
          mul_add_rows<MAXR>(acc, tab, nj, jj, nrows, xs[jj * K2_THREADS + threadIdx.x]);
    }
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
      if (i < nrows)
        store_word(out_seg + (r0 + i) * out_stride, c, g.len, aligned, acc[i]);
  }
}

template <int MAXR>
int launch_k1(const void* tables, int rows, int n, const void* segs, int nseg,
              long long max_len, void* out, long long out_stride, void* stream) {
  const size_t smem = 32ull * rows * n;
  const long long cols = K1_THREADS * K1_VECS_PER_THREAD * 16;
  const dim3 grid(static_cast<unsigned>((max_len + cols - 1) / cols),
                  static_cast<unsigned>(nseg));
  const cudaError_t err = cudaFuncSetAttribute(
      gf_apply_k1<MAXR>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gf_apply_k1<MAXR><<<grid, K1_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tables), rows, n, static_cast<const long long*>(segs),
      static_cast<uint8_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launchers return cudaGetLastError() after the launch (0 on success).
int gf_apply_k1_launch(const void* tables, int rows, int n, const void* segs, int nseg,
                       long long max_len, void* out, long long out_stride,
                       void* stream) {
  if (rows <= 4)
    return launch_k1<4>(tables, rows, n, segs, nseg, max_len, out, out_stride, stream);
  if (rows <= 8)
    return launch_k1<8>(tables, rows, n, segs, nseg, max_len, out, out_stride, stream);
  return launch_k1<16>(tables, rows, n, segs, nseg, max_len, out, out_stride, stream);
}

int gf_apply_k2_launch(const void* tables, int rows, int n, int band_rows, int chunk_rows,
                       const void* segs, int nseg, long long max_len, void* out,
                       long long out_stride, void* stream) {
  // one chunk of a band's tables + the chunk's input tile
  // (ops/gf_kernels.k2_smem_bytes)
  const size_t smem = 32ull * band_rows * chunk_rows + 4ull * K2_THREADS * chunk_rows;
  const long long cols = K2_THREADS * 4;
  dim3 grid(static_cast<unsigned>((max_len + cols - 1) / cols),
            static_cast<unsigned>(nseg));
  cudaError_t err = cudaFuncSetAttribute(
      gf_apply_k2<16>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gf_apply_k2<16><<<grid, K2_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tables), rows, n, band_rows, chunk_rows,
      static_cast<const long long*>(segs), static_cast<uint8_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
