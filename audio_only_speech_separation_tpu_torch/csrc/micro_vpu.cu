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
// question is HFMA2 on __nv_bfloat162 against FFMA on f32, so the chain is
// written with those instructions and nothing else in the loop: the f32
// case runs FFMA, FMUL and a compare-select; the bf16 case runs HFMA2,
// HMUL2, a packed compare to a mask (__hge2_mask) and one LOP3 select per
// two elements.  The multiply-add rounds once where the JAX package's
// x*a + b rounds twice.
//
// What bounds it on this card.  The array is read once and written once
// (8 bytes an element in f32, 4 in bf16); the chain does 64 * 5 operations
// an element (64 * 8 with stats, the script's count, scripts/micro_vpu.py
// :63-65), 40 (f32) or 80 (bf16) operations a byte moved, against the 20
// (f32) or 40 (bf16x2) a byte at which the CUDA cores rather than HBM set
// the time.  So the floor is the CUDA cores' rate: 132 SMs x 128 f32 lanes
// a cycle, twice the elements in bf16x2.
//
// What the design does about it: no shared memory and no barrier in the
// chain.  One thread runs 4 f32 (one float4) or 8 bf16 (four
// __nv_bfloat162, one 16-byte load) elements through the 64 steps in
// registers: four independent chains a thread; at [2048, 512] about 8
// (f32) or 4 (bf16) blocks of 256 threads an SM, one wave.  With stats each
// thread keeps one f32 sum, each block writes one partial (a warp shuffle
// tree, then the warps' sums in order), and a second launch sums the
// partials in a fixed order in every block (no atomics, as in K1-K3),
// writes the total and adds total*1e-30 to the output.
//
// One launch a call, two with stats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kReps = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v) {
  // the same fixed tree in every block and every call
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  return s;
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads) chain_f32(const float4* __restrict__ x, float4* __restrict__ out,
                                                      float* __restrict__ partials, int nvec, float a,
                                                      float b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  if (i < nvec) {
    const float4 v = x[i];
    float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll 4
    for (int r = 0; r < kReps; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = fmaf(e[j], a, b);
        e[j] = y >= 0.f ? y : a * y;
        if (kStats) acc = fmaf(e[j], e[j], acc);
      }
    }
    out[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  if (kStats) {
    const float s = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

template <bool kStats>
__global__ void __launch_bounds__(kThreads) chain_bf16(const uint4* __restrict__ x, uint4* __restrict__ out,
                                                       float* __restrict__ partials, int nvec, float a,
                                                       float b) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const __nv_bfloat162 a2 = __float2bfloat162_rn(a), b2 = __float2bfloat162_rn(b);
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  float acc = 0.f;
  if (i < nvec) {
    uint4 v = x[i];
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll 4
    for (int r = 0; r < kReps; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 y = __hfma2(e[j], a2, b2);
        const __nv_bfloat162 ay = __hmul2(a2, y);
        const uint32_t keep = __hge2_mask(y, zero2);  // 0xffff in each half where y >= 0
        const uint32_t sel = (bits(y) & keep) | (bits(ay) & ~keep);
        e[j] = *reinterpret_cast<const __nv_bfloat162*>(&sel);
        if (kStats) {
          const float2 f = __bfloat1622float2(e[j]);
          acc = fmaf(f.x, f.x, acc);
          acc = fmaf(f.y, f.y, acc);
        }
      }
    }
    out[i] = v;
  }
  if (kStats) {
    const float s = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
}

// The second launch with stats: every block sums the partials in the same
// fixed order; block 0 writes the total; every element gets total * 1e-30
// added in the output's dtype (bf16: bf16(bf16(total) * bf16(1e-30))).
__device__ __forceinline__ float sum_partials(const float* __restrict__ partials, int nparts) {
  float s = 0.f;
  for (int p = threadIdx.x; p < nparts; p += kThreads) s += partials[p];
  return block_sum(s);
}

__global__ void __launch_bounds__(kThreads) finish_f32(float4* __restrict__ out, const float* __restrict__ partials,
                                                       int nparts, int nvec, float* __restrict__ total) {
  const float s = sum_partials(partials, nparts);
  if (blockIdx.x == 0 && threadIdx.x == 0) *total = s;
  const float t = s * 1e-30f;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    float4 v = out[i];
    v.x += t;
    v.y += t;
    v.z += t;
    v.w += t;
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads) finish_bf16(uint4* __restrict__ out, const float* __restrict__ partials,
                                                        int nparts, int nvec, float* __restrict__ total) {
  const float s = sum_partials(partials, nparts);
  if (blockIdx.x == 0 && threadIdx.x == 0) *total = s;
  const __nv_bfloat16 t = __hmul(__float2bfloat16_rn(s), __float2bfloat16_rn(1e-30f));
  const __nv_bfloat162 t2 = __halves2bfloat162(t, t);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    uint4 v = out[i];
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = __hadd2(e[j], t2);
    out[i] = v;
  }
}

int blocks_for(int n, int bf16) { return ((n / (bf16 ? 8 : 4)) + kThreads - 1) / kThreads; }

}  // namespace

// Partials (f32) a stats call of n elements needs: one a block.
extern "C" int micro_vpu_partials(int n, int bf16) { return blocks_for(n, bf16); }

// Launches of one call.
extern "C" int micro_vpu_launches(int with_stats) { return with_stats ? 2 : 1; }

// x, out: n contiguous elements (bf16 if bf16, else f32), 16-byte aligned,
// n a multiple of 8 (bf16) or 4 (f32).  With stats, partials holds
// micro_vpu_partials(n, bf16) floats of scratch and total one float, the
// sum of squares.  Returns the cudaError_t of the launches.
extern "C" int micro_vpu(const void* x, void* out, void* partials, void* total, int n, int bf16,
                         int with_stats, float a, float b, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const int nvec = n / (bf16 ? 8 : 4);
  const int grid = blocks_for(n, bf16);
  float* parts = static_cast<float*>(partials);
  if (bf16) {
    const uint4* xv = static_cast<const uint4*>(x);
    uint4* ov = static_cast<uint4*>(out);
    if (with_stats) {
      chain_bf16<true><<<grid, kThreads, 0, s>>>(xv, ov, parts, nvec, a, b);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      finish_bf16<<<grid, kThreads, 0, s>>>(ov, parts, grid, nvec, static_cast<float*>(total));
    } else {
      chain_bf16<false><<<grid, kThreads, 0, s>>>(xv, ov, parts, nvec, a, b);
    }
  } else {
    const float4* xv = static_cast<const float4*>(x);
    float4* ov = static_cast<float4*>(out);
    if (with_stats) {
      chain_f32<true><<<grid, kThreads, 0, s>>>(xv, ov, parts, nvec, a, b);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      finish_f32<<<grid, kThreads, 0, s>>>(ov, parts, grid, nvec, static_cast<float*>(total));
    } else {
      chain_f32<false><<<grid, kThreads, 0, s>>>(xv, ov, parts, nvec, a, b);
    }
  }
  return cudaGetLastError();
}
