// gLN over channels-last samples, for Hopper (sm_90a), all in bf16, with an
// optional residual added in the same pass.  Per sample b (every axis but
// the batch, n elements, the channels last and C of them):
//   mean = mean_c + c,  var = max(E[(x-c)^2] - mean_c^2, 0),  mean_c = E[x-c]
//   (c the sample's first element: the shifted-data formula of
//   ``ops/norms.py::_moments``), then for every element
//   y = bf16((x - mean) / sqrt(var + eps)),  y = bf16(y * gamma),
//   y = bf16(y + beta),  and with a residual r: y = bf16(r + y),
// the roundings of the plain path (a float32 chain, cast to bf16, then torch's
// bf16 affine and add, each an f32 operation rounded once): the subtraction,
// the division (``__fdiv_rn``) and the square root (``__fsqrt_rn``) are IEEE
// float32 operations, none contracted into an FMA.  So the kernel differs
// from the plain path only in the order of the statistics' sums.
//
// Replaces no TPU kernel: the JAX package leaves gLN and the residual adds to
// XLA.  It was added for the card, where the plain path runs about 17 device
// operations a gLN, most of them float32 passes over the whole tensor
// (Sandglasset's 15 gLNs a request over its [8, 259, 250, 128] block tensor
// were half of the request's device time).
//
// What bounds it: bytes.  A gLN needs x (and r) read and y written once;
// the two-pass form reads x twice, a few float32 operations an element, far
// below the card's 295 FLOP a byte.  The design keeps device memory busy:
// - two launches, each over the same partition of every sample into blocks
//   of VECS 16-byte vectors (8 bf16 each; the last block of a sample may be
//   short), so the grid has several waves of CTAs on 132 SMs;
// - gln_stats_kernel: each thread issues all of its loads of x before it
//   sums, (x - c) and (x - c)^2 in float32, reduced over the CTA by warp
//   shuffles and shared memory; one float2 partial a CTA in a [B, P] scratch;
// - gln_apply_kernel: each CTA issues its first loads of x (and r), then
//   combines its sample's P partials in double in a fixed order (no atomics:
//   the result is the same from run to run), derives mean and the square
//   root, and streams its block, gamma and beta held in shared memory;
// - 16-byte loads and stores throughout, no float32 intermediate in device
//   memory.
// No allocation, no synchronisation: the wrapper allocates y and the
// scratch and launches on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int VECS = 2048;                   // 16-byte vectors a CTA (32 KiB of x)
constexpr int STATS_PER_THREAD = VECS / THREADS;  // 8 loads in flight a thread
constexpr int APPLY_PER_THREAD = 4;          // vectors a thread a step of the apply pass
constexpr int APPLY_STEP = APPLY_PER_THREAD * THREADS;
constexpr int MAX_CVEC = 128;                // C / 8 for C <= 1024
constexpr int WARPS = THREADS / 32;

// the 8 bf16 of a 16-byte vector as f32
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__global__ void __launch_bounds__(THREADS)
    gln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ partials, int n_vec, int P) {
  const int b = blockIdx.x / P, p = blockIdx.x - b * P;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + (size_t)b * n_vec;
  const int lo = p * VECS, hi = min(lo + VECS, n_vec);
  uint4 v[STATS_PER_THREAD];
#pragma unroll
  for (int u = 0; u < STATS_PER_THREAD; ++u) {
    const int i = lo + u * THREADS + (int)threadIdx.x;
    if (i < hi) v[u] = __ldg(xv + i);
  }
  const float c = __bfloat162float(x[(size_t)b * n_vec * 8]);
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int u = 0; u < STATS_PER_THREAD; ++u) {
    if (lo + u * THREADS + (int)threadIdx.x < hi) {
      float f[8];
      unpack8(v[u], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = f[k] - c;
        s1 += d;
        s2 += d * d;
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  __shared__ float red[2][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      t1 += red[0][w];
      t2 += red[1][w];
    }
    partials[blockIdx.x] = make_float2(t1, t2);
  }
}

template <bool RES>
__device__ __forceinline__ void load_step(const uint4* __restrict__ xv, const uint4* __restrict__ rv, int s, int hi,
                                          uint4 (&xs)[APPLY_PER_THREAD], uint4 (&rs)[APPLY_PER_THREAD]) {
#pragma unroll
  for (int u = 0; u < APPLY_PER_THREAD; ++u) {
    const int i = s + u * THREADS + (int)threadIdx.x;
    if (i < hi) {
      xs[u] = __ldg(xv + i);
      if (RES) rs[u] = __ldg(rv + i);
    }
  }
}

// with a residual the pass holds twice the vectors in registers: capped so
// that 3 CTAs share an SM (at 2, 106 registers a thread, the pass over the
// Sandglasset block tensor took 10 % longer)
template <bool RES>
__global__ void __launch_bounds__(THREADS, RES ? 3 : 4)
    gln_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r, const bf16* __restrict__ gamma,
                     const bf16* __restrict__ beta, const float2* __restrict__ partials, bf16* __restrict__ y,
                     int n_vec, int P, int cvec, float eps) {
  __shared__ uint4 gs[MAX_CVEC], bs[MAX_CVEC];
  __shared__ double red[2][WARPS];
  __shared__ float stat[2];
  const int b = blockIdx.x / P, p = blockIdx.x - b * P;
  const size_t base = (size_t)b * n_vec;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + base;
  const uint4* rv = RES ? reinterpret_cast<const uint4*>(r) + base : nullptr;
  uint4* yv = reinterpret_cast<uint4*>(y) + base;
  const int lo = p * VECS, hi = min(lo + VECS, n_vec);

  // the first step's loads in flight while the statistics are combined
  uint4 xs[APPLY_PER_THREAD], rs[APPLY_PER_THREAD];
  load_step<RES>(xv, rv, lo, hi, xs, rs);
  for (int i = threadIdx.x; i < cvec; i += THREADS) {
    gs[i] = __ldg(reinterpret_cast<const uint4*>(gamma) + i);
    bs[i] = __ldg(reinterpret_cast<const uint4*>(beta) + i);
  }
  // the sample's P partials, each thread's in index order, then the warps' and
  // the CTA's in a fixed order: every CTA of the sample gets the same sums
  double a1 = 0.0, a2 = 0.0;
  const float2* part = partials + (size_t)b * P;
  for (int q = threadIdx.x; q < P; q += THREADS) {
    const float2 t = part[q];
    a1 += (double)t.x;
    a2 += (double)t.y;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = a1;
    red[1][warp] = a2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t1 = 0.0, t2 = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      t1 += red[0][w];
      t2 += red[1][w];
    }
    const double inv_n = 1.0 / (8.0 * (double)n_vec);
    const float c = __bfloat162float(x[base * 8]);
    const float mean_c = (float)(t1 * inv_n), m2 = (float)(t2 * inv_n);
    float var = __fsub_rn(m2, __fmul_rn(mean_c, mean_c));
    var = var < 0.0f ? 0.0f : var;  // torch.clamp(min=0): a NaN stays NaN
    stat[0] = __fadd_rn(mean_c, c);
    stat[1] = __fsqrt_rn(__fadd_rn(var, eps));
  }
  __syncthreads();
  const float mean = stat[0], denom = stat[1];

  for (int s = lo; s < hi; s += APPLY_STEP) {
    if (s != lo) load_step<RES>(xv, rv, s, hi, xs, rs);
#pragma unroll
    for (int u = 0; u < APPLY_PER_THREAD; ++u) {
      const int i = s + u * THREADS + (int)threadIdx.x;
      if (i < hi) {
        const int ci = i % cvec;  // a sample starts at channel 0: n % C == 0
        float f[8], gf[8], bf[8], rf[8];
        unpack8(xs[u], f);
        unpack8(gs[ci], gf);
        unpack8(bs[ci], bf);
        if (RES) unpack8(rs[u], rf);
        uint4 o;
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int k = 0; k < 8; k += 2) {
          float out[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float t = round_bf16(__fdiv_rn(__fsub_rn(f[k + j], mean), denom));
            float v = __fadd_rn(round_bf16(__fmul_rn(t, gf[k + j])), bf[k + j]);
            if (RES) v = __fadd_rn(rf[k + j], round_bf16(v));
            out[j] = v;
          }
          op[k / 2] = __floats2bfloat162_rn(out[0], out[1]);
        }
        yv[i] = o;
      }
    }
  }
}

}  // namespace

// gLN of x [B, n] (each sample n = L x C elements, channels last) with gamma
// and beta [C], plus r [B, n] where r is not null, into y, on ``stream`` of
// ``device``: two launches (the device made current for them, and the
// caller's restored).  x, r, y, gamma and beta are contiguous, 16-byte
// aligned bf16 device tensors; n_vec = n / 8 vectors a sample; partials a
// float32 scratch of at least B x ceil(n_vec / 2048) float2 (``capacity``
// counts them).  8 <= C <= 1024 with C % 8 == 0 and n_vec % (C / 8) == 0.
// Returns a cudaError_t (cudaErrorInvalidValue outside that envelope).
extern "C" int global_layer_norm(const void* x, const void* r, const void* gamma, const void* beta, void* partials,
                                 long long capacity, void* y, int B, int n_vec, int C, float eps, int device,
                                 void* stream_ptr) {
  if (C < 8 || C > 8 * MAX_CVEC || C % 8 != 0 || B < 0 || n_vec < 0 || n_vec % (C / 8) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_vec == 0) return (int)cudaSuccess;
  const long long P = (n_vec + VECS - 1) / VECS;
  if (P * B > capacity || P * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16 *xp = static_cast<const bf16*>(x), *rp = static_cast<const bf16*>(r);
  const bf16 *gp = static_cast<const bf16*>(gamma), *bp = static_cast<const bf16*>(beta);
  float2* pp = static_cast<float2*>(partials);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int grid = (int)(P * B);
  gln_stats_kernel<<<grid, THREADS, 0, st>>>(xp, pp, n_vec, (int)P);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    if (rp)
      gln_apply_kernel<true><<<grid, THREADS, 0, st>>>(xp, rp, gp, bp, pp, yp, n_vec, (int)P, C / 8, eps);
    else
      gln_apply_kernel<false><<<grid, THREADS, 0, st>>>(xp, rp, gp, bp, pp, yp, n_vec, (int)P, C / 8, eps);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
