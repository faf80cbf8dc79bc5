// Elementwise probe for Hopper (sm_90a): a 64-step chain of a multiply-add
// and a PReLU-style select on every element, optionally with the f32 sum of
// squares of each step's result, in f32 or in packed bf16.
//
// Replaces the TPU kernel scripts/micro_vpu.py::make_kernel of the JAX
// package, entered through scripts/micro_vpu.py::bench.  The contract is
// the same: 64 times x = x*a + b, x = where(x >= 0, x, a*x) (a, b rounded to
// x's dtype), with stats acc += sum(f32(x)^2) over the whole array; the
// output is x + acc*1e-30 in x's dtype.  The TPU script asked whether
// packed bf16 elementwise work runs at twice the f32 rate, which decides
// whether a kernel stays bf16 through its epilogues.  On Hopper the same
// question is HFMA2 on __nv_bfloat162 against FFMA on f32.  The multiply-add
// rounds once where the JAX package's x*a + b rounds twice.
//
// What bounds it on this card.  The array is read once and written once
// (8 bytes an element in f32, 4 in bf16); the chain does 64 * 5 operations
// an element (64 * 8 with stats, the script's count, scripts/micro_vpu.py
// :63-65), 40 (f32) or 80 (bf16) operations a byte moved, against the 20
// (f32) or 40 (bf16x2) a byte at which the CUDA cores rather than HBM set
// the time.  So the floor is the CUDA cores' rate: 132 SMs x 128 f32 lanes
// a cycle, twice the elements in bf16x2.  That prices a step of a bf16 pair
// at 2.5 packed issue slots (4 with stats).
//
// What the design does about it.
// - The select is one min or max.  For a >= 1, where(y >= 0, y, a*y) is
//   min(y, a*y) under any monotone rounding, signed zeros included; for
//   0 <= a <= 1 it is max(y, a*y).  A step of a pair is HFMA2, HMUL2 and
//   HMNMX2: 3 issue slots against the bound's 2.5 (the mask and LOP3
//   select it replaced took 4-5).  f32 takes FFMA, FMUL, FMNMX.  The entry
//   picks min or max from a; a < 0 is refused.
// - One launch plan: blocks of kThreads, each thread kWords 32-bit words
//   (bf16 pairs, or f32 elements), each an independent chain, in registers
//   from its loads to one store: 8 elements a thread (4 words of bf16
//   pairs, 8 f32 words without stats, 4 with), 512 blocks of 256 at
//   [2048, 512] (1024 in f32 with stats).  __launch_bounds__ keeps a thread at <= 32 registers.
//   Measured on the card, independent chains a thread beat thread slots
//   (scripts/profile_port_micro_vpu.py builds the other plans it compares
//   from this file with -DMICRO_VPU_THREADS and -DMICRO_VPU_WORDS).
// - With stats, one cooperative launch: each block sums its threads' f32
//   accumulators into a partial (a warp shuffle tree, then the warps in
//   order), all blocks meet at a grid barrier, and every block sums all
//   partials in one fixed order, adds total*1e-30 to the elements it still
//   holds in registers and stores them once.  No atomics in the sum: the
//   total is the same from run to run.  The grid must be co-resident; a
//   shape where it is not is outside the kernel (micro_vpu_fits).
// - Without stats the launch allows programmatic dependent launch: it may
//   be scheduled while the previous kernel in the stream drains, and waits
//   (griddepcontrol.wait) before touching memory.
//
// What still holds it (PERF.md section 6): the call's fixed cost (launch,
// the first loads' latency, the stores' drain; with stats the cooperative
// launch and grid barrier), which the profile script times with a build of
// -DMICRO_VPU_REPS=0, and packed bf16 issuing below the lane rate the bound
// assumes.
//
// One launch a call, with or without stats.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The chain's length, the threads of a block and, when defined, the words
// of a thread in every case.  The library is built with the defaults; a
// profile build may set them.
#ifndef MICRO_VPU_REPS
#define MICRO_VPU_REPS 64
#endif
#ifndef MICRO_VPU_THREADS
#define MICRO_VPU_THREADS 256
#endif
#ifndef MICRO_VPU_PDL
#define MICRO_VPU_PDL 1
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kSlotsPerSM = 2048;  // resident threads an SM
constexpr int kThreads = MICRO_VPU_THREADS;

// 32-bit words a thread in each case
template <bool kBf16, bool kStats>
__host__ __device__ constexpr int words_of() {
#ifdef MICRO_VPU_WORDS
  return MICRO_VPU_WORDS;
#else
  return kBf16 || kStats ? 4 : 8;
#endif
}

template <int kWords>
struct Vec;
template <>
struct Vec<2> {
  using T = uint2;
};
template <>
struct Vec<4> {
  using T = uint4;
};
struct Uint8 {
  uint4 lo, hi;
};
template <>
struct Vec<8> {
  using T = Uint8;
};

__device__ __forceinline__ float block_sum(float v) {
  // the same fixed tree in every block and every call; every thread gets the sum
  __shared__ float warp_sums[kThreads / 32];
  __syncthreads();  // warp_sums may still be read from a previous call
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  return s;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t w) { return *reinterpret_cast<__nv_bfloat162*>(&w); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// The select of a step, y -> where(y >= 0, y, a*y): min(y, a*y) if kMin
// (a >= 1), else max(y, a*y) (0 <= a < 1).
template <bool kBf16, bool kStats, bool kMin>
__global__ void __launch_bounds__(kThreads, kSlotsPerSM / kThreads)
    chain(const typename Vec<words_of<kBf16, kStats>()>::T* __restrict__ x,
          typename Vec<words_of<kBf16, kStats>()>::T* __restrict__ out, float* __restrict__ partials,
          float* __restrict__ total, int nvec, int reps, float a, float b) {
  constexpr int kWords = words_of<kBf16, kStats>();
  asm volatile("griddepcontrol.wait;" ::: "memory");  // a no-op unless launched with programmatic dependence
  const int i = blockIdx.x * kThreads + threadIdx.x;
  typename Vec<kWords>::T v = {};
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
  float acc = 0.f;
  if (i < nvec) {
    v = x[i];
    if constexpr (kBf16) {
      const __nv_bfloat162 a2 = __float2bfloat162_rn(a), b2 = __float2bfloat162_rn(b);
#pragma unroll 4
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const __nv_bfloat162 y = __hfma2(as_bf162(w[j]), a2, b2);
          const __nv_bfloat162 ay = __hmul2(a2, y);
          w[j] = bits(kMin ? __hmin2(y, ay) : __hmax2(y, ay));
          if constexpr (kStats) {
            const float lo = __uint_as_float(w[j] << 16), hi = __uint_as_float(w[j] & 0xffff0000u);
            acc = fmaf(lo, lo, acc);
            acc = fmaf(hi, hi, acc);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const float y = fmaf(__uint_as_float(w[j]), a, b);
          const float ay = a * y;
          const float e = kMin ? fminf(y, ay) : fmaxf(y, ay);
          w[j] = __float_as_uint(e);
          if constexpr (kStats) acc = fmaf(e, e, acc);
        }
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;");
  if constexpr (kStats) {
    const float part = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = part;
    cg::this_grid().sync();
    float s = 0.f;
    for (int p = threadIdx.x; p < gridDim.x; p += kThreads) s += __ldcg(partials + p);
    s = block_sum(s);
    if (blockIdx.x == 0 && threadIdx.x == 0) *total = s;
    if constexpr (kBf16) {
      const __nv_bfloat16 t = __hmul(__float2bfloat16_rn(s), __float2bfloat16_rn(1e-30f));
      const __nv_bfloat162 t2 = __halves2bfloat162(t, t);
#pragma unroll
      for (int j = 0; j < kWords; ++j) w[j] = bits(__hadd2(as_bf162(w[j]), t2));
    } else {
      const float t = s * 1e-30f;
#pragma unroll
      for (int j = 0; j < kWords; ++j) w[j] = __float_as_uint(__uint_as_float(w[j]) + t);
    }
  }
  if (i < nvec) out[i] = v;
}

template <bool kBf16, bool kStats>
__host__ __device__ constexpr int per_thread() {
  return words_of<kBf16, kStats>() * (kBf16 ? 2 : 1);
}

int per_thread_of(int bf16, int with_stats) {
  return bf16 ? (with_stats ? per_thread<true, true>() : per_thread<true, false>())
              : (with_stats ? per_thread<false, true>() : per_thread<false, false>());
}

int grid_for(int n, int bf16, int with_stats) {
  const int nvec = n / per_thread_of(bf16, with_stats);
  return (nvec + kThreads - 1) / kThreads;
}

template <bool kBf16, bool kStats, bool kMin>
cudaError_t launch(const void* x, void* out, float* partials, float* total, int n, float a, float b,
                   cudaStream_t s) {
  using V = typename Vec<words_of<kBf16, kStats>()>::T;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_for(n, kBf16, kStats));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (kStats) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = MICRO_VPU_PDL;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = chain<kBf16, kStats, kMin>;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const V*>(x), static_cast<V*>(out),
                            partials, total, n / per_thread<kBf16, kStats>(), MICRO_VPU_REPS, a, b);
}

template <bool kBf16, bool kStats>
cudaError_t by_select(bool min_select, const void* x, void* out, float* partials, float* total, int n, float a,
                      float b, cudaStream_t s) {
  return min_select ? launch<kBf16, kStats, true>(x, out, partials, total, n, a, b, s)
                    : launch<kBf16, kStats, false>(x, out, partials, total, n, a, b, s);
}

template <bool kBf16>
cudaError_t blocks_per_sm(int* per_sm) {
  // both selects of a stats call, the fewer resident blocks of the two
  auto with_min = chain<kBf16, true, true>, with_max = chain<kBf16, true, false>;
  int lo = 0, hi = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lo, with_min, kThreads, 0);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&hi, with_max, kThreads, 0);
  *per_sm = lo < hi ? lo : hi;
  return err;
}

}  // namespace

// Elements a thread holds: a call's n must be a multiple of it.
extern "C" int micro_vpu_per_thread(int bf16, int with_stats) { return per_thread_of(bf16, with_stats); }

// Blocks of a call of n elements (and the f32 partials a stats call needs).
extern "C" int micro_vpu_partials(int n, int bf16, int with_stats) { return grid_for(n, bf16, with_stats); }

// Launches of one call.
extern "C" int micro_vpu_launches(int with_stats) { return 1; }

// 1 if a call fits the kernel: without stats always, with stats if its grid
// is co-resident on the current device (the cooperative launch needs it);
// 0 if not; a negative cudaError_t if the device cannot be queried.
extern "C" int micro_vpu_fits(int n, int bf16, int with_stats) {
  if (!with_stats) return 1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = bf16 ? blocks_per_sm<true>(&per_sm) : blocks_per_sm<false>(&per_sm);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return grid_for(n, bf16, with_stats) <= sms * per_sm ? 1 : 0;
}

// x, out: n contiguous elements (bf16 if bf16, else f32), 16-byte aligned,
// n a multiple of micro_vpu_per_thread(...).
// With stats, partials holds micro_vpu_partials(...) floats of scratch and
// total one float, the sum of squares, and the call must fit
// (micro_vpu_fits).  a >= 0: the select is min(y, a*y) for a >= 1 and
// max(y, a*y) below.  Returns the cudaError_t of the launch.
extern "C" int micro_vpu(const void* x, void* out, void* partials, void* total, int n, int bf16, int with_stats,
                         float a, float b, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  float* parts = static_cast<float*>(partials);
  float* tot = static_cast<float*>(total);
  if (!(a >= 0.f)) return cudaErrorInvalidValue;
  const bool min_select = a >= 1.f;
  cudaError_t err;
  if (bf16)
    err = with_stats ? by_select<true, true>(min_select, x, out, parts, tot, n, a, b, s)
                     : by_select<true, false>(min_select, x, out, parts, tot, n, a, b, s);
  else
    err = with_stats ? by_select<false, true>(min_select, x, out, parts, tot, n, a, b, s)
                     : by_select<false, false>(min_select, x, out, parts, tot, n, a, b, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
