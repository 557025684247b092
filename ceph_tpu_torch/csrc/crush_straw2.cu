// Batched CRUSH straw2 choose on Hopper (K3), and the crush_ln probe.
//
// Replaces:
//   crush_straw2_k3   <- ceph_tpu/ops/pallas_crush.py:176 `_score_kernel`
//                        (launched by straw2_scores_pallas, :214) fused with
//                        its caller's draw and first-max argmax
//                        (ceph_tpu/crush/batched.py:112 straw2_choose_b)
//   crush_ln_scores   <- the same TPU kernel's own function alone: crush_ln
//                        of every (x, item, r) draw, [B, S] int64
//   crush_ln_stream   <- the two Pallas probes, perf_runs/probe_gather.py:33
//                        `run` (table lookups) and perf_runs/probe_flat.py:48
//                        `ln_kernel` (crush_ln over a flat stream)
//
// What bounds it.  K3 reads 16 bytes per lane (x, r, bucket index, out) and
// a map of a few hundred KB that stays in L2, but does ~100 32-bit integer
// operations per slot it walks (the rjenkins hash's five mixes, crush_ln,
// the draw's multiply and shift): it is bound by integer operations, not
// bytes.  The probe does a few operations per 12 bytes moved and is bound
// by bytes.
//
// Design.  The TPU kernel computes crush_ln by one-hot bf16 matmuls into
// byte-limb planes over padded [tile, 128] blocks, because the TPU has no
// vector gather and no 64-bit integers.  None of that is carried over: a
// thread here indexes tables directly and has native 64-bit arithmetic.
//
// K3's draw.  mapper.c divides (crush_ln(u) - 2^48) by the slot's weight
// with a 64-bit signed divide, an ~80-instruction subroutine on this card.
// Weights are map constants, so the host gives every slot an exact magic
// reciprocal (crush/magic_div.py): with p = 2^48 - crush_ln(u) in
// [0, 2^48], q = ((p + a) * M) >> k == p / w, one 64x64->128 multiply and
// a two-word shift.  The draw is -q, so the first strict maximum of the
// draws is the first strict minimum of q; a slot with no weight gets
// q = UINT64_MAX, above every real q (<= 2^48), and when every slot has
// none slot 0 wins, as mapper.c's `i == 0 ||` gives.
//
// K3's lanes.  T threads (a power of two up to 32, chosen by the host
// from B, S and the SM count so that B * T fills about one wave) share a
// lane: thread t walks slots t, t + T, ..., so a group reads consecutive
// words of the row, and the group then reduces (q, slot) with
// __shfl_xor_sync, the smaller q winning and on equal q the smaller slot,
// which is the serial strict scan's answer.  A group lies inside one
// warp, and the threads past B stay in the shuffle and write nothing.
// At T = 1 (B alone fills the card) it is one thread per lane.
//
// crush_ln has two forms, chosen by a template argument:
//   LN_COMPUTE (a): mapper.c's own arithmetic (clz, one 64-bit multiply)
//                   over RH_LH_TBL and LL_TBL (4 KB, staged in shared memory)
//   LN_TABLE   (b): one load from CRUSH_LN_TABLE (512 KB of int64, served
//                   from L2)
// The probe times both over a flat stream.  K3 and ln_scores are compiled
// in one form, K3_LN_FORM: the table form, which was faster inside K3 on
// an H100 though the probe's byte-bound stream favours (a) (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEM_NONE = -0x7FFFFFFE;
constexpr long long LN_BIAS = 0x1000000000000LL;
// a slot with no weight: above every real quotient (<= 2^48)
constexpr unsigned long long Q_NONE = ~0ULL;
// the packed magic word's fields (ops/crush_kernels.py::straw2_magic):
// k in bits 0-7, a in bit 8, and bit 9 set for a slot with no weight
constexpr int KA_SHIFT_MASK = 0xFF;
constexpr int KA_INC_BIT = 8;
constexpr int KA_NO_WEIGHT = 1 << 9;
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;
constexpr int RH_LH_ENTRIES = 258;  // 129 (RH, LH) pairs
constexpr int LL_ENTRIES = 256;
// blocks per SM of a grid-stride launch
constexpr int BLOCKS_PER_SM = 8;

enum LnForm { LN_COMPUTE = 0, LN_TABLE = 1 };
// the one crush_ln form K3 and ln_scores are built with
constexpr int K3_LN_FORM = LN_TABLE;

struct LnTables {
  const long long* rh_lh;  // [258]
  const long long* ll;     // [256]
  const long long* full;   // [65536] CRUSH_LN_TABLE
};

struct SmemLn {
  long long rh_lh[RH_LH_ENTRIES];
  long long ll[LL_ENTRIES];
};

// hash.c :: crush_hashmix, mod 2^32
__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= (c >> 13);
  b -= c; b -= a; b ^= (a << 8);
  c -= a; c -= b; c ^= (b >> 13);
  a -= b; a -= c; a ^= (c >> 12);
  b -= c; b -= a; b ^= (a << 16);
  c -= a; c -= b; c ^= (b >> 5);
  a -= b; a -= c; a ^= (c >> 3);
  b -= c; b -= a; b ^= (a << 10);
  c -= a; c -= b; c ^= (b >> 15);
}

// hash.c :: crush_hash32_rjenkins1_3
__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = 1315423911u ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// Form (a) keeps its two small tables in shared memory; every thread of
// the block must call this before its first crush_ln.
template <int FORM>
__device__ __forceinline__ void stage_tables(SmemLn& s, const LnTables& t) {
  if (FORM == LN_COMPUTE) {
    for (int i = threadIdx.x; i < RH_LH_ENTRIES; i += blockDim.x) s.rh_lh[i] = t.rh_lh[i];
    for (int i = threadIdx.x; i < LL_ENTRIES; i += blockDim.x) s.ll[i] = t.ll[i];
    __syncthreads();
  }
}

// mapper.c :: crush_ln(u) for u in [0, 0xffff]: log2(u + 1) in 16.44 fixed
// point (ln_table.py::crush_ln_scalar).  x * rh can reach 2^63, so the
// product is unsigned.
__device__ __forceinline__ long long ln_compute(uint32_t u, const SmemLn& s) {
  uint32_t x = u + 1;
  int iexpon = 15;
  if (!(x & 0x18000u)) {
    const int bits = __clz(x & 0x1FFFFu) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  const int index1 = (x >> 8) << 1;  // even, in [256, 512]
  const unsigned long long rh = s.rh_lh[index1 - 256];
  const long long lh = s.rh_lh[index1 + 1 - 256];
  const unsigned long long xl64 = (static_cast<unsigned long long>(x) * rh) >> 48;
  const long long ll = s.ll[xl64 & 0xFF];
  return (static_cast<long long>(iexpon) << 44) + ((lh + ll) >> 4);
}

template <int FORM>
__device__ __forceinline__ long long crush_ln(uint32_t u, const SmemLn& s,
                                              const LnTables& t) {
  if (FORM == LN_COMPUTE) return ln_compute(u, s);
  return __ldg(t.full + u);
}

// floor(p / w) = ((p + a) * M) >> k for p in [0, 2^48], k in [48, 96]
// (crush/magic_div.py): the product's two words, then a two-word shift.  A
// 64-bit shift by 64 is undefined, so k >= 64 takes the high word alone.
__device__ __forceinline__ unsigned long long magic_quotient(unsigned long long pa,
                                                             unsigned long long m, int k) {
  const unsigned long long lo = pa * m;
  const unsigned long long hi = __umul64hi(pa, m);
  return k >= 64 ? hi >> (k - 64) : (hi << (64 - k)) | (lo >> k);
}

// K3: for each lane, bucket_straw2_choose over bucket `bucket_idx` (clamped
// to the table) with the magic of row min(position, P-1) * n_idx + bucket;
// T threads per lane (a power of two dividing 32, blockDim.x == THREADS).
__global__ void __launch_bounds__(THREADS) straw2_choose_kernel(
    const int* __restrict__ items, const long long* __restrict__ magic_m,
    const int* __restrict__ magic_ka, const int* __restrict__ sizes, int n_idx, int S,
    int P, const int* __restrict__ bucket_idx, const int* __restrict__ xs,
    const int* __restrict__ rs, const int* __restrict__ position, long long B, int T,
    LnTables t, int* __restrict__ out) {
  __shared__ SmemLn s;
  stage_tables<K3_LN_FORM>(s, t);
  const int t_shift = __ffs(T) - 1;  // T is a power of two
  const int lanes_per_block = THREADS >> t_shift;
  const int sub = threadIdx.x & (T - 1);
  const long long stride = static_cast<long long>(gridDim.x) * lanes_per_block;
  // `base` is the same for the whole block, so every thread of a warp
  // reaches the shuffles below
  for (long long base = static_cast<long long>(blockIdx.x) * lanes_per_block; base < B;
       base += stride) {
    const long long lane = base + (threadIdx.x >> t_shift);
    const bool live = lane < B;
    int size = 0;
    const int* it = items;
    const unsigned long long* m = reinterpret_cast<const unsigned long long*>(magic_m);
    const int* ka = magic_ka;
    uint32_t x = 0, r = 0;
    if (live) {
      const int b = min(max(bucket_idx[lane], 0), n_idx - 1);
      size = min(sizes[b], S);
      const int row = P > 1 ? min(max(position[lane], 0), P - 1) * n_idx + b : b;
      it += static_cast<long long>(b) * S;
      m += static_cast<long long>(row) * S;
      ka += static_cast<long long>(row) * S;
      x = static_cast<uint32_t>(xs[lane]);
      r = static_cast<uint32_t>(rs[lane]);
    }
    unsigned long long best_q = Q_NONE;
    int best = sub;
#pragma unroll 1
    for (int i = sub; i < size; i += T) {
      const int kai = ka[i];
      const uint32_t u = hash32_3(x, static_cast<uint32_t>(it[i]), r) & 0xFFFFu;
      const unsigned long long pa =
          static_cast<unsigned long long>(LN_BIAS + ((kai >> KA_INC_BIT) & 1)) -
          static_cast<unsigned long long>(crush_ln<K3_LN_FORM>(u, s, t));
      unsigned long long q = magic_quotient(pa, m[i], kai & KA_SHIFT_MASK);
      q = (kai & KA_NO_WEIGHT) ? Q_NONE : q;
      if (q < best_q) {  // strict: the first minimum of this thread's slots
        best_q = q;
        best = i;
      }
    }
#pragma unroll 1
    for (int off = T >> 1; off > 0; off >>= 1) {
      const unsigned long long oq = __shfl_xor_sync(FULL_WARP, best_q, off);
      const int ob = __shfl_xor_sync(FULL_WARP, best, off);
      if (oq < best_q || (oq == best_q && ob < best)) {
        best_q = oq;
        best = ob;
      }
    }
    if (live && sub == 0) out[lane] = size > 0 ? it[best] : ITEM_NONE;
  }
}

// The TPU kernel's function alone: out[e] = crush_ln(hash3(x, item, r) &
// 0xffff) for every element e = lane * S + slot of a [B, S] block (B * S <
// 2^31, checked by the host).
__global__ void __launch_bounds__(THREADS) ln_scores_kernel(
    const int* __restrict__ xs, const int* __restrict__ items,
    const int* __restrict__ rs, int n, int S, LnTables t, long long* __restrict__ out) {
  __shared__ SmemLn s;
  stage_tables<K3_LN_FORM>(s, t);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int lane = e / S;
    const uint32_t u = hash32_3(static_cast<uint32_t>(xs[lane]),
                                static_cast<uint32_t>(items[e]),
                                static_cast<uint32_t>(rs[lane])) & 0xFFFFu;
    out[e] = crush_ln<K3_LN_FORM>(u, s, t);
  }
}

// The probe: crush_ln of a flat stream of u values.
template <int FORM>
__global__ void __launch_bounds__(THREADS) ln_stream_kernel(
    const int* __restrict__ u, long long n, LnTables t, long long* __restrict__ out) {
  __shared__ SmemLn s;
  stage_tables<FORM>(s, t);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = crush_ln<FORM>(static_cast<uint32_t>(u[i]) & 0xFFFFu, s, t);
}

// The current device's SM count, read once per device.
int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

// A grid-stride launch's blocks: enough to fill every SM of the current
// device, no more than the work needs.
unsigned grid_for(long long work) {
  const long long want = (work + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sm_count()) * BLOCKS_PER_SM;
  return static_cast<unsigned>(want < cap ? want : cap);
}

LnTables tables(const void* rh_lh, const void* ll, const void* full) {
  return LnTables{static_cast<const long long*>(rh_lh), static_cast<const long long*>(ll),
                  static_cast<const long long*>(full)};
}

}  // namespace

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).

// threads: T, the threads per lane, a power of two from 1 to 32.
extern "C" int crush_straw2_choose_launch(
    const void* items, const void* magic_m, const void* magic_ka, const void* sizes,
    int n_idx, int S, int P, const void* bucket_idx, const void* x, const void* r,
    const void* position, long long B, int threads, const void* rh_lh, const void* ll,
    const void* full, void* out, void* stream) {
  if (threads < 1 || threads > 32 || (threads & (threads - 1)) != 0)
    return cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const long long lanes_per_block = THREADS / threads;
  const long long blocks = (B + lanes_per_block - 1) / lanes_per_block;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30));
  auto st = static_cast<cudaStream_t>(stream);
  const LnTables t = tables(rh_lh, ll, full);
  const auto* it = static_cast<const int*>(items);
  const auto* mm = static_cast<const long long*>(magic_m);
  const auto* ka = static_cast<const int*>(magic_ka);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* bi = static_cast<const int*>(bucket_idx);
  const auto* xs = static_cast<const int*>(x);
  const auto* rs = static_cast<const int*>(r);
  const auto* pos = static_cast<const int*>(position);
  auto* o = static_cast<int*>(out);
  straw2_choose_kernel<<<grid, THREADS, 0, st>>>(it, mm, ka, sz, n_idx, S, P, bi, xs, rs, pos,
                                                 B, threads, t, o);
  return cudaGetLastError();
}

extern "C" int crush_ln_scores_launch(const void* x, const void* items,
                                      const void* r, int B, int S, const void* rh_lh,
                                      const void* ll, const void* full, void* out,
                                      void* stream) {
  const int n = B * S;  // the host checks B * S < 2^31
  if (n <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const LnTables t = tables(rh_lh, ll, full);
  const auto* xs = static_cast<const int*>(x);
  const auto* it = static_cast<const int*>(items);
  const auto* rs = static_cast<const int*>(r);
  auto* o = static_cast<long long*>(out);
  ln_scores_kernel<<<grid_for(n), THREADS, 0, st>>>(xs, it, rs, n, S, t, o);
  return cudaGetLastError();
}

// form: 0 = LN_COMPUTE, 1 = LN_TABLE.
extern "C" int crush_ln_stream_launch(int form, const void* u, long long n,
                                      const void* rh_lh, const void* ll, const void* full,
                                      void* out, void* stream) {
  if (n <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const LnTables t = tables(rh_lh, ll, full);
  const auto* uu = static_cast<const int*>(u);
  auto* o = static_cast<long long*>(out);
  if (form == LN_COMPUTE)
    ln_stream_kernel<LN_COMPUTE><<<grid_for(n), THREADS, 0, st>>>(uu, n, t, o);
  else if (form == LN_TABLE)
    ln_stream_kernel<LN_TABLE><<<grid_for(n), THREADS, 0, st>>>(uu, n, t, o);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
