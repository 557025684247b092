// GF(2^8) matrix apply on Hopper: out[rows, L] = mat[rows, n] x in[n, L].
//
// Replaces the two Pallas kernels of ceph_tpu/ops/pallas_gf.py:
//   gf_apply_k1  <- _apply_kernel          (pallas_gf.py:184, rb == 1)
//   gf_apply_k2  <- _apply_kernel_blocked  (pallas_gf.py:202, rb > 1)
//
// Both read n*L bytes and write rows*L bytes, and read each input byte
// from device memory once.  The TPU kernel's G row grouping, VMEM model
// and bf16 pack-by-matmul are TPU layout and are not carried over.
//
// K1, for thin matrices (RS encode and decode): split-nibble multiply
// tables (ISA-L's form).  For a matrix entry c the 32-byte table holds
// lo[x] = c*x and hi[x] = c*(x << 4) for the 16 nibble values x, so
// c*b = lo[b & 15] ^ hi[b >> 4].  A nibble lookup for 4 bytes is two
// __byte_perm over the table's two 8-byte halves and a byte select on the
// nibble's top bit.  The tables of the whole matrix sit in one block's
// shared memory (the host sends a matrix here when rows <= MAX_ROWS and
// the tables fit K1_MAX_TABLE_BYTES, see ops/gf_kernels.py) and every
// thread of a warp reads the same entry (a broadcast).  Each block walks
// a column tile of all n input rows; a thread owns 16 byte columns and
// issues the next row's load before the current row's lookups.  Bound by
// bytes: the RS shapes do ~n*rows lookups per byte moved.
//
// K2, for fat matrices (CLAY repair [64, 176] and [256, 960]): a bitplane
// product on the tensor cores, the TPU kernel's own formulation.  A GF(2^8)
// product by a constant is linear over GF(2), so the [rows, n] matrix is a
// 0/1 matrix of [8*rows, 8*n] (gf/matrix.py::matrix_to_bitmatrix) and the
// apply is its integer product with the input's bits, taken mod 2.  What
// bounds it: the bytes on HBM ((n + rows) * L) and the int8 tensor-core
// rate for 2 * 64 * rows * n * L operations; at the CLAY shapes the
// second is ~10x the first (0.048 against 0.0047 ms for the repair), so
// the design is about feeding mma.sync.m16n8k32.s8 from packed operands:
//
//   * The operand (ops/gf_kernels.py::k2_operand, built once per matrix
//     on the host) is the bitmatrix packed 8 bits to a byte like the
//     input (byte j of a row holds k = 8*j + bit), rows padded to a
//     multiple of 8 and n to a multiple of K2_STAGE_ROWS with zeros.  In
//     each 64-row tile, row 8*b + i holds bit b of output row i.
//   * Both operands stay packed in shared memory (1/8 of an s8 copy).  A
//     k-step of the mma takes 4 input rows x 8 bits; the 4 k of one
//     register are bit t of those 4 rows (t = lane % 4, and t + 4 for the
//     second register), so a fragment register is (word >> t) & 0x01010101
//     of a word that holds the 4 rows' bytes.  The A word is 4 bytes of an
//     operand row; the B words come from a 4x4 byte transpose (__byte_perm)
//     of 4 input rows at the lane's 4 columns.
//   * A warp owns the block's 64 bitmatrix rows (8 output rows) x 64 byte
//     columns, in 4 m16 x 8 n8 fragments.  Its n8 fragment f takes column
//     8*g + f for lane group g, so that a lane's accumulators (rows g and
//     g + 8 of each m16 fragment, columns 2t and 2t + 1) are bits 0..7 of
//     output row g over 16 consecutive columns: each lane packs its own
//     16 output bytes and stores them, with no shuffle.  Sums are exact
//     mod 2^32, so the parity is right for any n.
//   * Blocks of 4 warps over (8-output-row tiles) x (256-column tiles) x
//     (segments, on grid.y): 2048 blocks at the CLAY(8,4,d=11) repair.
//     A block loops over K in stages of K2_STAGE_ROWS input rows, staged
//     with cp.async into a double buffer (16-byte copies when the segment
//     is 16-byte aligned, 4-byte copies when it is word aligned, byte
//     loads otherwise; bytes past the segment's end and rows past n read
//     0).  The 128 accumulators take ~214 registers a thread, so 2 blocks
//     (8 warps) share an SM; a 64 x 32 warp tile at 4 blocks an SM issues
//     5.3 instructions per mma against 3.9 here and was 7-10 % slower on
//     the card (PERF.md, Findings).
//
// Several input segments (the stripes of a fused flush) go through one
// launch of either kernel: segment s is [n, len_s] at its own pointer and
// row stride and lands at output columns [out_col_s, out_col_s + len_s).
// Ragged lengths and unaligned rows are masked in the kernel; the host
// pads nothing.
#include <cstdint>
#include <cuda_runtime.h>
namespace {

constexpr int K1_THREADS = 256;
constexpr int K1_VECS_PER_THREAD = 2;  // 16-byte vectors: 8192 byte columns per block

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

// acc[i] ^= mat[i, j] * x for four words x at once: each table entry is
// read once for all four; entry (i, j) at tab[2 * (i * n + j)].
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

// ---- K2: the bitplane product on the tensor cores ----

constexpr int K2_WARPS = 4;
constexpr int K2_THREADS = 32 * K2_WARPS;
constexpr int K2_NFRAG = 8;                             // n8 fragments per warp
constexpr int K2_WARP_COLS = 8 * K2_NFRAG;              // 64 byte columns
constexpr int K2_TILE_COLS = K2_WARPS * K2_WARP_COLS;   // 256 byte columns per block
constexpr int K2_TILE_ROWS = 8;                         // output rows per block
constexpr int K2_TILE_BITROWS = 8 * K2_TILE_ROWS;       // operand rows per block
constexpr int K2_STAGE_ROWS = 64;                       // input rows per stage
// operand rows in shared memory: 16 bytes of padding put the 8 rows a
// warp reads at once (one per lane group) in 8 different banks
constexpr int K2_OP_PITCH = K2_STAGE_ROWS + 16;
constexpr int K2_OP_STAGE_BYTES = K2_TILE_BITROWS * K2_OP_PITCH;
constexpr int K2_STAGE_BYTES = K2_OP_STAGE_BYTES + K2_STAGE_ROWS * K2_TILE_COLS;
constexpr int K2_SMEM_BYTES = 2 * K2_STAGE_BYTES;       // double buffer (ops/gf_kernels.k2_layout)
constexpr uint32_t LOW_BITS = 0x01010101u;

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(uint8_t* dst, const uint8_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// How a segment's rows can be copied: 16 (16-byte aligned), 4 (word
// aligned) or 1 (bytes).
__device__ __forceinline__ int copy_width(const Segment& g) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g.in) | static_cast<uintptr_t>(g.stride);
  return (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
}

// One stage into buf: the block's operand rows at bytes [j0, j0 + STAGE)
// (the operand is padded, every byte exists) and input rows
// [j0, j0 + STAGE) at columns [c0, c0 + TILE_COLS), 0 past n and len.
// Whole 16-byte pieces go by cp.async; the rest by plain loads and stores.
__device__ __forceinline__ void k2_stage(uint8_t* buf, const uint8_t* op, int op_pitch,
                                         const Segment& g, int n, int j0, long long c0,
                                         int width) {
  constexpr int OP_PIECES = K2_STAGE_ROWS / 16;
  for (int i = threadIdx.x; i < K2_TILE_BITROWS * OP_PIECES; i += K2_THREADS) {
    const int p = i / OP_PIECES, piece = i % OP_PIECES;
    cp_async16(buf + p * K2_OP_PITCH + 16 * piece,
               op + static_cast<long long>(p) * op_pitch + j0 + 16 * piece);
  }
  uint8_t* xs = buf + K2_OP_STAGE_BYTES;
  constexpr int X_PIECES = K2_TILE_COLS / 16;
  for (int i = threadIdx.x; i < K2_STAGE_ROWS * X_PIECES; i += K2_THREADS) {
    const int jj = i / X_PIECES, piece = i % X_PIECES;
    uint8_t* dst = xs + jj * K2_TILE_COLS + 16 * piece;
    const long long c = c0 + 16 * piece;
    const long long valid = j0 + jj < n ? max(0LL, min(16LL, g.len - c)) : 0;
    if (valid == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint8_t* src = g.in + static_cast<long long>(j0 + jj) * g.stride + c;
    if (valid == 16 && width == 16) {
      cp_async16(dst, src);
    } else if (valid == 16 && width == 4) {
#pragma unroll
      for (int w = 0; w < 4; ++w) cp_async4(dst + 4 * w, src + 4 * w);
    } else {
      for (int b = 0; b < 16; ++b) dst[b] = b < valid ? src[b] : 0;
    }
  }
}

// 4x4 byte transpose: byte f of c[q] is byte q of r[f].
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// B fragments of k-step s (input rows 4s..4s+3 of the stage) for the
// lane's NFRAG columns xs[.., col + f]: register b0[f] holds bit t of the
// 4 rows' bytes, b1[f] bit t + 4 (one 0/1 byte per k).
__device__ __forceinline__ void k2_b_frags(const uint8_t* xs, int s, int col, int t,
                                           uint32_t (&b0)[K2_NFRAG], uint32_t (&b1)[K2_NFRAG]) {
#pragma unroll
  for (int v = 0; v < K2_NFRAG / 4; ++v) {
    uint32_t r[4], c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = *reinterpret_cast<const uint32_t*>(xs + (4 * s + q) * K2_TILE_COLS + col + 4 * v);
    transpose4(r, c);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      b0[4 * v + f] = (c[f] >> t) & LOW_BITS;
      b1[4 * v + f] = (c[f] >> (t + 4)) & LOW_BITS;
    }
  }
}

// A fragment of m16 fragment m at k-step s: operand rows 16m + g (a0, a2)
// and 16m + 8 + g (a1, a3), bit t (a0, a1) and t + 4 (a2, a3) of the
// bytes of input rows 4s..4s+3.
__device__ __forceinline__ void k2_a_frag(const uint8_t* as, int s, int m, int g, int t,
                                          uint32_t (&a)[4]) {
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(as + (16 * m + g) * K2_OP_PITCH + 4 * s);
  const uint32_t w1 =
      *reinterpret_cast<const uint32_t*>(as + (16 * m + 8 + g) * K2_OP_PITCH + 4 * s);
  a[0] = (w0 >> t) & LOW_BITS;
  a[1] = (w1 >> t) & LOW_BITS;
  a[2] = (w0 >> (t + 4)) & LOW_BITS;
  a[3] = (w1 >> (t + 4)) & LOW_BITS;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's output bytes from its accumulators: byte NFRAG*h + f is
// column 2*NFRAG*t + NFRAG*h + f of the warp's tile, bit 2m of it in
// acc[m][f][h] and bit 2m + 1 in acc[m][f][2 + h].
__device__ __forceinline__ void k2_pack(const int (&acc)[4][K2_NFRAG][4],
                                        uint32_t (&words)[K2_NFRAG / 2]) {
#pragma unroll
  for (int u = 0; u < K2_NFRAG / 2; ++u) words[u] = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int f = 0; f < K2_NFRAG; ++f) {
      uint32_t byte = 0;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        byte |= (static_cast<uint32_t>(acc[m][f][h]) & 1u) << (2 * m) |
                (static_cast<uint32_t>(acc[m][f][2 + h]) & 1u) << (2 * m + 1);
      const int e = K2_NFRAG * h + f;
      words[e / 4] |= byte << (8 * (e % 4));
    }
}

__global__ void __launch_bounds__(K2_THREADS, 2)
gf_apply_k2(const uint8_t* __restrict__ op, int rows, int n, int op_pitch,
            const long long* __restrict__ segs, uint8_t* __restrict__ out,
            long long out_stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row_tiles = (rows + K2_TILE_ROWS - 1) / K2_TILE_ROWS;
  const int tile = blockIdx.x % row_tiles;
  const long long c0 = static_cast<long long>(blockIdx.x / row_tiles) * K2_TILE_COLS;
  const Segment g = load_segment(segs, blockIdx.y);
  if (c0 >= g.len) return;  // whole block: this segment is shorter
  const int width = copy_width(g);
  const uint8_t* op_tile = op + static_cast<long long>(tile) * K2_TILE_BITROWS * op_pitch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, t = lane % 4;
  const int col = warp * K2_WARP_COLS + K2_NFRAG * grp;  // the lane's B columns

  int acc[4][K2_NFRAG][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int f = 0; f < K2_NFRAG; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][f][i] = 0;

  const int stages = (n + K2_STAGE_ROWS - 1) / K2_STAGE_ROWS;
  k2_stage(smem, op_tile, op_pitch, g, n, 0, c0, width);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages)
      k2_stage(smem + ((st + 1) & 1) * K2_STAGE_BYTES, op_tile, op_pitch, g, n,
               (st + 1) * K2_STAGE_ROWS, c0, width);
    cp_async_commit();
    cp_async_wait_one();  // stage st has landed
    __syncthreads();
    const uint8_t* as = smem + (st & 1) * K2_STAGE_BYTES;
    const uint8_t* xs = as + K2_OP_STAGE_BYTES;
    const int steps = (min(K2_STAGE_ROWS, n - st * K2_STAGE_ROWS) + 3) / 4;
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      uint32_t b0[K2_NFRAG], b1[K2_NFRAG];
      k2_b_frags(xs, s, col, t, b0, b1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t a[4];
        k2_a_frag(as, s, m, grp, t, a);
#pragma unroll
        for (int f = 0; f < K2_NFRAG; ++f) mma_s8(acc[m][f], a, b0[f], b1[f]);
      }
    }
    __syncthreads();  // buffer st & 1 is free for stage st + 2
  }

  const int row = tile * K2_TILE_ROWS + grp;
  const long long lc = c0 + warp * K2_WARP_COLS + 2 * K2_NFRAG * t;  // segment column
  if (row >= rows || lc >= g.len) return;
  uint32_t words[K2_NFRAG / 2];
  k2_pack(acc, words);
  uint8_t* dst = out + row * out_stride + g.out_col + lc;
  const bool aligned8 = ((reinterpret_cast<uintptr_t>(out) | static_cast<uintptr_t>(out_stride) |
                          static_cast<uintptr_t>(g.out_col)) & 7) == 0;
  if (aligned8 && lc + 2 * K2_NFRAG <= g.len) {
#pragma unroll
    for (int u = 0; u < K2_NFRAG / 2; u += 2)
      *reinterpret_cast<uint2*>(dst + 4 * u) = make_uint2(words[u], words[u + 1]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 2 * K2_NFRAG; ++e)
    if (lc + e < g.len) dst[e] = static_cast<uint8_t>(words[e / 4] >> (8 * (e % 4)));
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

// op: k2_operand(mat) on the device, [8 * ceil(rows / 8) * 8, op_pitch].
int gf_apply_k2_launch(const void* op, int rows, int n, int op_pitch, const void* segs,
                       int nseg, long long max_len, void* out, long long out_stride,
                       void* stream) {
  const long long row_tiles = (rows + K2_TILE_ROWS - 1) / K2_TILE_ROWS;
  const long long col_tiles = (max_len + K2_TILE_COLS - 1) / K2_TILE_COLS;
  const dim3 grid(static_cast<unsigned>(row_tiles * col_tiles), static_cast<unsigned>(nseg));
  const cudaError_t err = cudaFuncSetAttribute(
      gf_apply_k2, cudaFuncAttributeMaxDynamicSharedMemorySize, K2_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  gf_apply_k2<<<grid, K2_THREADS, K2_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(op), rows, n, op_pitch, static_cast<const long long*>(segs),
      static_cast<uint8_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
