// Device helpers shared by the ConvTasNet kernels for Hopper (sm_90a):
// the separator and TCN-chain forward (convtasnet_separator.cu) and the
// chain backward (convtasnet_backward.cu).
//
// Tiles: a thread block (or, in the forward's block body, a warpgroup)
// owns TILE = 64 frames of one sample.  Products use bf16 WMMA fragments
// (16x16x16, f32 accumulate) on operand tiles staged in shared memory with
// row stride LDA (bf16) and products staged with row stride LDC (f32);
// the backward's weight gradients use mma.sync fed by cp.async, and the
// forward's block body wgmma fed by bulk copies (in their own files).
// Reductions are written as per-tile partials and summed in a fixed order:
// no atomics anywhere, so a run repeats bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;       // frames per thread block
constexpr int C = 128;         // bottleneck channels
constexpr int WIN = 16;        // filter length
constexpr int CH = 128;        // hidden channels per chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int LDA = CH + 8;    // bf16 row stride of staged operand tiles
constexpr int LDC = CH + 4;    // f32 row stride of staged products
constexpr float EPS = 1e-8f;

// vecs rows (f32 [8, H] per block); row 7 is padding
constexpr int V_B1 = 0, V_DWB = 1, V_G1 = 2, V_BT1 = 3, V_DW0 = 4, V_DW1 = 5, V_DW2 = 6;

constexpr int A_BYTES = TILE * LDA * 2;     // [TILE][LDA] bf16
constexpr int B_BYTES = CH * LDA * 2;       // [128][LDA] bf16
constexpr int C_BYTES = TILE * LDC * 4;     // [TILE][LDC] f32

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

__device__ __forceinline__ float prelu(float x, float a) { return x >= 0.f ? x : a * x; }

__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  return u;
}

__device__ __forceinline__ float4 unpack4(uint2 u) {
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum (s, q) over the block (blockDim.x a multiple of 32, at most 256) in
// a fixed order; thread 0 writes out[0..1].
__device__ void block_sum2_store(float s, float q, float* out) {
  __shared__ float red[2][NWARPS];
  s = warp_sum(s);
  q = warp_sum(q);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][w] = s;
    red[1][w] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      ts += red[0][i];
      tq += red[1][i];
    }
    out[0] = ts;
    out[1] = tq;
  }
}

// The sum of v over the block (blockDim.x a multiple of 32), in a fixed
// order, returned to every thread.
__device__ float block_allreduce(float v) {
  __shared__ float red[32];
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();  // a previous call may still be reading red
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  __syncthreads();
  return t;
}

// Mean and 1/std of one sample from its n_tiles (sum, sumsq) partials,
// summed in a fixed order; E[x^2] - mean^2 clamped at 0, plus eps.
__device__ void finish_stats(const float* part, int n_tiles, float inv_count, float* ms) {
  if (threadIdx.x < 32) {
    float s = 0.f, q = 0.f;
    for (int i = threadIdx.x; i < n_tiles; i += 32) {
      s += part[2 * i];
      q += part[2 * i + 1];
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (threadIdx.x == 0) {
      const float mean = s * inv_count;
      const float var = fmaxf(q * inv_count - mean * mean, 0.f);
      ms[0] = mean;
      ms[1] = 1.f / sqrtf(var + EPS);
    }
  }
  __syncthreads();
}

// dst[r][c] = src[r * lds + c] for a rows x cols bf16 tile; cols % 8 == 0
// and both sides 16-byte aligned.
__device__ __forceinline__ void load_tile(bf16* dst, int ldd, const bf16* src, size_t lds,
                                          int rows, int cols) {
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
  }
}

__device__ __forceinline__ void zero_acc(Acc* acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
}

// acc += A[TILE][K] @ B[K][128], both staged with row stride LDA.  Warp w
// owns rows 16*(w&3) .. +16 and columns 64*(w>>2) .. +64 (four fragments).
__device__ __forceinline__ void mma_tile(Acc* acc, const bf16* A, const bf16* B, int K) {
  const int w = threadIdx.x >> 5;
  const bf16* a_base = A + (w & 3) * 16 * LDA;
  const bf16* b_base = B + (w >> 2) * 64;
  for (int k = 0; k < K; k += 16) {
    FragA a;
    wmma::load_matrix_sync(a, a_base + k, LDA);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, b_base + k * LDA + 16 * j, LDA);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// acc += A[TILE][K] @ Bt^T, with Bt staged as [128][K] (row stride LDA):
// the product with a transposed weight, read column-major from the tile.
// Same warp layout as mma_tile.
__device__ __forceinline__ void mma_tile_bt(Acc* acc, const bf16* A, const bf16* Bt, int K) {
  const int w = threadIdx.x >> 5;
  const bf16* a_base = A + (w & 3) * 16 * LDA;
  const bf16* b_base = Bt + (w >> 2) * 64 * LDA;
  for (int k = 0; k < K; k += 16) {
    FragA a;
    wmma::load_matrix_sync(a, a_base + k, LDA);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBc b;
      wmma::load_matrix_sync(b, b_base + 16 * j * LDA + k, LDA);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// The [TILE][128] product of mma_tile into dst (f32, row stride ld).
__device__ __forceinline__ void store_acc(const Acc* acc, float* dst, int ld) {
  const int w = threadIdx.x >> 5;
  float* base = dst + (w & 3) * 16 * ld + (w >> 2) * 64;
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(base + 16 * j, acc[j], ld, wmma::mem_row_major);
}

// cp.async (16-byte global -> shared copies) and its groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

// As cp_async16, but writes 16 zero bytes and reads nothing unless ``valid``.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace

#define RETURN_IF_ERROR(expr)                  \
  do {                                         \
    cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)
