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
// a map of a few hundred KB that stays in L2, but does ~200 32-bit integer
// operations per slot it walks (the rjenkins hash's five mixes, crush_ln,
// a 64-bit signed divide): it is bound by integer operations, not bytes.
// The probe does a few operations per 12 bytes moved and is bound by bytes.
//
// Design.  The TPU kernel computes crush_ln by one-hot bf16 matmuls into
// byte-limb planes over padded [tile, 128] blocks, because the TPU has no
// vector gather and no 64-bit integers.  None of that is carried over: a
// thread here indexes tables directly and has native 64-bit arithmetic.
// K3 gives each lane (one placement draw) one thread, which walks only its
// bucket's `size` slots (not the padded row: a host row is padded to the
// root's 128 but holds 8 items) and keeps the first strict maximum, with
// slot 0 winning when every slot draws S64_MIN, as mapper.c does.
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
constexpr long long S64_MIN = -0x7FFFFFFFFFFFFFFFLL - 1;
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

// K3: for each lane, bucket_straw2_choose over bucket `bucket_idx` (clamped
// to the table) with weights from row min(position, P-1) * n_idx + bucket.
__global__ void __launch_bounds__(THREADS) straw2_choose_kernel(
    const int* __restrict__ items, const long long* __restrict__ weights,
    const int* __restrict__ sizes, int n_idx, int S, int P,
    const int* __restrict__ bucket_idx, const int* __restrict__ xs,
    const int* __restrict__ rs, const int* __restrict__ position, long long B,
    LnTables t, int* __restrict__ out) {
  __shared__ SmemLn s;
  stage_tables<K3_LN_FORM>(s, t);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       lane < B; lane += stride) {
    const int b = min(max(bucket_idx[lane], 0), n_idx - 1);
    const int size = min(sizes[b], S);
    if (size <= 0) {
      out[lane] = ITEM_NONE;
      continue;
    }
    const int row = P > 1 ? min(max(position[lane], 0), P - 1) * n_idx + b : b;
    const int* it = items + static_cast<long long>(b) * S;
    const long long* w = weights + static_cast<long long>(row) * S;
    const uint32_t x = static_cast<uint32_t>(xs[lane]);
    const uint32_t r = static_cast<uint32_t>(rs[lane]);
    int high = 0;
    long long high_draw = 0;
    for (int i = 0; i < size; ++i) {
      const long long wi = w[i];
      long long draw = S64_MIN;
      if (wi > 0) {
        const uint32_t u = hash32_3(x, static_cast<uint32_t>(it[i]), r) & 0xFFFFu;
        draw = (crush_ln<K3_LN_FORM>(u, s, t) - LN_BIAS) / wi;  // truncating, as div64_s64
      }
      if (i == 0 || draw > high_draw) {
        high = i;
        high_draw = draw;
      }
    }
    out[lane] = it[high];
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

// A grid-stride launch's blocks: enough to fill every SM, no more than the
// work needs.
unsigned grid_for(long long work) {
  static int sms = 0;
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess)
    sms = 132;
  const long long want = (work + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  return static_cast<unsigned>(want < cap ? want : cap);
}

LnTables tables(const void* rh_lh, const void* ll, const void* full) {
  return LnTables{static_cast<const long long*>(rh_lh), static_cast<const long long*>(ll),
                  static_cast<const long long*>(full)};
}

}  // namespace

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).

extern "C" int crush_straw2_choose_launch(
    const void* items, const void* weights, const void* sizes, int n_idx, int S,
    int P, const void* bucket_idx, const void* x, const void* r, const void* position,
    long long B, const void* rh_lh, const void* ll, const void* full, void* out,
    void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30));
  auto st = static_cast<cudaStream_t>(stream);
  const LnTables t = tables(rh_lh, ll, full);
  const auto* it = static_cast<const int*>(items);
  const auto* w = static_cast<const long long*>(weights);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* bi = static_cast<const int*>(bucket_idx);
  const auto* xs = static_cast<const int*>(x);
  const auto* rs = static_cast<const int*>(r);
  const auto* pos = static_cast<const int*>(position);
  auto* o = static_cast<int*>(out);
  straw2_choose_kernel<<<grid, THREADS, 0, st>>>(it, w, sz, n_idx, S, P, bi, xs, rs, pos, B, t,
                                                 o);
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
