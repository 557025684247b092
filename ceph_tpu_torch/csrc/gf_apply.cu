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
// K1, for thin matrices (RS encode and decode).  A product by a constant c
// is linear over GF(2), so with a byte b split into bit fields of 3, 3 and
// 2 bits, c*b = TA[b & 7] ^ TB[(b >> 3) & 7] ^ TC[b >> 6], where TA[x] = c*x,
// TB[x] = c*(x << 3) and TC[x] = c*(x << 6).  A table of at most 8 entries
// fits two registers, so one PRMT looks a field up for 4 bytes at once,
// and since a selector nibble stays below 8 no byte select is needed
// (ISA-L's 16-entry split-nibble table takes two __byte_perm and a select
// a lookup).  A field's selector costs a mask, an IMAD and a PRMT (and a
// shift for the upper two), shared by the matrix's rows; the lookups of
// two input rows fold into an output word with three LOP3, so a word and
// matrix entry costs 3 PRMT and 1.5 LOP3.  An entry's 20 table bytes are
// padded to 32 (ops/gf_kernels.py::field_tables); the whole matrix's
// tables sit in one block's shared memory (the host sends a matrix here
// when rows <= MAX_ROWS and the tables fit K1_MAX_TABLE_BYTES) and every
// thread of a warp reads the same entry (a broadcast).  A thread owns one
// or two vectors of 16 byte columns; for each, its row loop issues the
// loads of K1_RING input rows before any lookup and runs the trip as one
// block of straight code, all MAXR accumulators computed (instantiations
// for 1, 2, 4, 8 and 16 rows; the rows past the matrix's are never
// stored).  The host fits the tile to the launch (ops/gf_kernels.py::
// k1_layout: the largest of 8192, 4096 and 2048 columns a block that
// still gives two blocks an SM) and passes up to K1_PARAM_SEGS segment
// descriptors by value in the kernel's parameters.  Bound by bytes, or
// at 8 input rows about as much by the INT32 pipe: chip_smoke.py counts
// the row loop in the SASS and logs that floor beside the byte bound.
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
#include <cstring>
#include <cuda_runtime.h>
namespace {

constexpr int K1_MAX_THREADS = 256;
constexpr int K1_MAX_VECS = 2;  // 16-byte vectors a thread: 8192 byte columns a block at most
// input rows whose loads a thread issues before any lookup
constexpr int K1_RING = 8;
// segment descriptors K1 takes by value (ops/gf_kernels.K1_PARAM_SEGS);
// a launch over more reads them from a device array
constexpr int K1_PARAM_SEGS = 120;
// the most table bytes a K1 matrix has (ops/gf_kernels.K1_MAX_TABLE_BYTES):
// within the 48 KiB of dynamic shared memory a launch gets without
// cudaFuncSetAttribute
constexpr int K1_MAX_TABLE_BYTES = 16 * 1024;
static_assert(K1_MAX_TABLE_BYTES <= 48 * 1024, "K1's tables need the shared-memory attribute");

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

// Everything a K1 launch takes, passed by value: the descriptors of up to
// K1_PARAM_SEGS segments ride in the kernel's parameters, so a launch over
// few segments needs no descriptor copy to the card.
struct K1Args {
  const uint4* tables;    // field_tables(mat): entry (i, j) at [2 * (i * n + j)]
  const long long* segs;  // device descriptors when nseg > K1_PARAM_SEGS
  uint8_t* out;
  long long out_stride;
  int rows, n, nseg, vecs;
  Segment seg[K1_PARAM_SEGS];
};
static_assert(sizeof(K1Args) <= 4096, "K1's parameters must fit the 4 KiB every toolkit takes");

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

__device__ __forceinline__ void store_vec(uint8_t* row, long long c, long long len,
                                          bool aligned16, bool aligned4, const uint32_t (&v)[4]) {
  if (aligned16 && c + 16 <= len) {
    *reinterpret_cast<uint4*>(row + c) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) store_word(row, c + 4 * k, len, aligned4, v[k]);
}

// Bytes y0..y3 (each < 8) -> the selector nibbles y1, y0, y3, y2:
// y * 0x1001 (one IMAD, on the FMA pipe beside the INT32 pipe's lookups)
// holds y1 | y0 << 4 in byte 1 and y3 | y2 << 4 in byte 3 (the fields do
// not overlap, so nothing carries), and the perm gathers those two bytes.
// So every lookup's output bytes come out swapped in pairs (1 0 3 2), and
// K1 swaps each accumulator back once, before its store.
__device__ __forceinline__ uint32_t selector(uint32_t y) {
  return __byte_perm(y * 0x1001u, 0, 0x4431);
}

// The three field selectors of one input word, shared by every matrix row.
struct Fields {
  uint32_t a, b, c;
};

__device__ __forceinline__ Fields split_fields(uint32_t x) {
  return {selector(x & 0x07070707u), selector((x >> 3) & 0x07070707u),
          selector((x >> 6) & 0x03030303u)};
}

// __byte_perm(a, b, s) for a selector known only at run time, without the
// mask (s & 0x7777) nvcc puts before each such PRMT: PTX prmt reads bit 3
// of a nibble as "replicate the byte's sign", and K1's selector nibbles
// are below 8.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// One matrix entry's tables from shared memory: TA in .x .y and TB in .z .w
// of tab[2 * e], TC in .x of tab[2 * e + 1].
struct Entry {
  uint4 ab;
  uint32_t c;
};

__device__ __forceinline__ Entry entry(const uint4* tab, int e) {
  return {tab[2 * e], reinterpret_cast<const uint32_t*>(tab + 2 * e + 1)[0]};
}

// c * x for the four bytes of x, from x's field selectors.
__device__ __forceinline__ uint32_t lookup(const Entry& t, const Fields& f) {
  return prmt(t.ab.x, t.ab.y, f.a) ^ prmt(t.ab.z, t.ab.w, f.b) ^ prmt(t.c, t.c, f.c);
}

// acc[i] ^= mat[i, j + r] * x[r] for R input rows (16 byte columns each):
// with R = 2 the six lookups of an output word fold into it with three
// LOP3, 1.5 a lookup pair.  Every one of the MAXR accumulators is
// computed; rows past `rows` repeat the last row and are never stored.
template <int MAXR, int R>
__device__ __forceinline__ void k1_step(uint32_t (&acc)[MAXR][4], const uint4* tab, int n,
                                        int rows, int j, const uint32_t (&x)[R][4]) {
  Fields f[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) f[r][k] = split_fields(x[r][k]);
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int row = min(i, rows - 1);
    Entry t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = entry(tab, row * n + j + r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t v = acc[i][k];
#pragma unroll
      for (int r = 0; r < R; ++r) v ^= lookup(t[r], f[r][k]);
      acc[i][k] = v;
    }
  }
}

// Bytes [c, c + 16) of an input row as four words.  VEC: they lie inside
// the segment on a 16-byte aligned row, one streaming 16-byte load (the
// input is read once); else word or byte loads, 0 past the end.
template <bool VEC>
__device__ __forceinline__ void k1_load(uint32_t (&x)[4], const uint8_t* row, long long c,
                                        long long len, bool a4) {
  if constexpr (VEC) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(row + c));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = load_word(row, c + 4 * k, len, a4);
  }
}

// acc = mat x in[:, c .. c + 16) over all n input rows.  K1's row loop
// takes K1_RING rows a trip, every load of the trip issued before its
// first lookup, and the trip is one block of straight code; the n %
// K1_RING rows left over go one at a time.
template <int MAXR, bool VEC>
__device__ __forceinline__ void k1_rows(uint32_t (&acc)[MAXR][4], const uint4* tab,
                                        const Segment& g, int rows, int n, long long c,
                                        bool a4) {
  const uint8_t* row = g.in;
  int j = 0;
#pragma unroll 1
  for (; j + K1_RING <= n; j += K1_RING) {
    uint32_t x[K1_RING / 2][2][4];
#pragma unroll
    for (int r = 0; r < K1_RING; ++r, row += g.stride)
      k1_load<VEC>(x[r / 2][r % 2], row, c, g.len, a4);
#pragma unroll
    for (int p = 0; p < K1_RING / 2; ++p) k1_step<MAXR, 2>(acc, tab, n, rows, j + 2 * p, x[p]);
  }
#pragma unroll 1
  for (; j < n; ++j, row += g.stride) {
    uint32_t x[1][4];
    k1_load<VEC>(x[0], row, c, g.len, a4);
    k1_step<MAXR, 1>(acc, tab, n, rows, j, x);
  }
}

// Blocks of K1_MAX_THREADS an SM: the registers the compiler may take
// (80 a thread at 3 blocks) leave room for 4 blocks at up to 2 rows, 3 at
// up to 4 (24 warps, against 16 at the 114 registers it takes unbounded;
// the packed flush runs ~11 % faster on an H100, PERF.md), 2 at 8 and 1
// at 16.
template <int MAXR>
__global__ void __launch_bounds__(K1_MAX_THREADS,
                                  MAXR <= 2 ? 4 : MAXR <= 4 ? 3 : MAXR <= 8 ? 2 : 1)
gf_apply_k1(const __grid_constant__ K1Args a) {
  extern __shared__ uint4 tab[];  // rows * n * 2
  const Segment g = a.nseg <= K1_PARAM_SEGS ? a.seg[blockIdx.y] : load_segment(a.segs, blockIdx.y);
  const long long tile0 = static_cast<long long>(blockIdx.x) * (blockDim.x * a.vecs * 16);
  if (tile0 >= g.len) return;  // whole block: this segment is shorter
  for (int t = threadIdx.x; t < a.rows * a.n * 2; t += blockDim.x) tab[t] = a.tables[t];
  __syncthreads();
  const bool a4 = words_aligned(g, a.out, a.out_stride);
  const bool a16 = vecs_aligned(g, a.out, a.out_stride);
  uint8_t* out_seg = a.out + g.out_col;
  for (int v = 0; v < a.vecs; ++v) {
    const long long c = tile0 + 16LL * (v * blockDim.x + threadIdx.x);
    if (c >= g.len) break;
    uint32_t acc[MAXR][4];
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0;
    if (a16 && c + 16 <= g.len)
      k1_rows<MAXR, true>(acc, tab, g, a.rows, a.n, c, a4);
    else
      k1_rows<MAXR, false>(acc, tab, g, a.rows, a.n, c, a4);
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = __byte_perm(acc[i][k], 0, 0x2301);
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
      if (i < a.rows) store_vec(out_seg + i * a.out_stride, c, g.len, a16, a4, acc[i]);
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
int launch_k1(const K1Args& a, long long max_len, int threads, void* stream) {
  const long long tile = static_cast<long long>(threads) * a.vecs * 16;
  const dim3 grid(static_cast<unsigned>((max_len + tile - 1) / tile), static_cast<unsigned>(a.nseg));
  const size_t smem = 32ull * a.rows * a.n;
  gf_apply_k1<MAXR><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both launchers return cudaGetLastError() after the launch (0 on success).
// K1: tables = field_tables(mat) on the device; the segment descriptors
// (four int64 each: input pointer, row stride, length, first output
// column) come from host memory (host_segs) when nseg <= K1_PARAM_SEGS,
// else from the device (dev_segs); threads and vecs are k1_layout's tile.
int gf_apply_k1_launch(const void* tables, int rows, int n, const void* host_segs,
                       const void* dev_segs, int nseg, long long max_len, void* out,
                       long long out_stride, int threads, int vecs, void* stream) {
  if (rows < 1 || rows > 16 || n < 1 || nseg < 1 || 32LL * rows * n > K1_MAX_TABLE_BYTES ||
      threads < 32 || threads > K1_MAX_THREADS || threads % 32 != 0 || vecs < 1 ||
      vecs > K1_MAX_VECS || (nseg <= K1_PARAM_SEGS ? host_segs : dev_segs) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  K1Args a = {};
  a.tables = static_cast<const uint4*>(tables);
  a.segs = static_cast<const long long*>(dev_segs);
  a.out = static_cast<uint8_t*>(out);
  a.out_stride = out_stride;
  a.rows = rows;
  a.n = n;
  a.nseg = nseg;
  a.vecs = vecs;
  if (nseg <= K1_PARAM_SEGS) std::memcpy(a.seg, host_segs, sizeof(Segment) * nseg);
  if (rows == 1) return launch_k1<1>(a, max_len, threads, stream);
  if (rows == 2) return launch_k1<2>(a, max_len, threads, stream);
  if (rows <= 4) return launch_k1<4>(a, max_len, threads, stream);
  if (rows <= 8) return launch_k1<8>(a, max_len, threads, stream);
  return launch_k1<16>(a, max_len, threads, stream);
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
