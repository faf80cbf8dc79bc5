// The residual add and LayerNorm of a pre-norm transformer layer, for
// Hopper (sm_90a), over rows of width d, all in bf16:
//   s = bf16(x + a),   h = bf16(LN(s) * gamma + beta)
// with the statistics of the rounded s in f32 (biased variance, eps inside
// the square root), as torch's bf16 add followed by ``F.layer_norm`` computes
// them.  Three forms, template parameters of one body:
// - residual: a is a tensor of x's shape (an attention or feed-forward
//   branch), s and h written;
// - position: a is a table [T, d], row r of x taking row r % T of it (the
//   sinusoidal positions added at a stack's first site), s and h written;
// - final: s not written (the last site of a stack, whose sum feeds only
//   the stack's final LayerNorm).
//
// Replaces no TPU kernel: the JAX package leaves its LayerNorms and adds to
// XLA.  It was added for the card, where the two library passes it takes
// the place of were the largest block of memory-bound device time in a
// Sepformer request (a separate bf16 add, then torch's
// ``vectorized_layer_norm_kernel``, which gives each 256-wide row a whole
// block and reached 4.4x its bound).
//
// What bounds it: bytes.  A site reads x and a once and writes h, and s
// where it is kept: 3 or 4 passes over [rows, d] in bf16, a handful of
// f32 operations an element, far below the card's 295 FLOP a byte.  So the
// design is about keeping device memory busy:
// - one warp a row, 8 bf16 a lane in each 16-byte load or store
//   (NV = ceil(d / 256) of them a lane, so d <= 1024); at d = 256 a row is
//   one load of x and one of a a lane;
// - the sum rounded to bf16 in registers, the mean and then the centred
//   variance of the rounded values each by one butterfly of warp shuffles
//   (two passes over registers, no shared memory, no barrier);
// - gamma and beta loaded once a warp and held in registers across rows;
// - a grid of as many 8-warp blocks as fit on the card at once, each warp
//   walking rows at a stride of the grid's warps, the next row's x and a
//   loaded before the current row is reduced, so two rows' loads are in
//   flight a warp.
// No allocation, no synchronisation: the wrapper allocates s and h and
// launches on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;  // warps (rows in flight) a block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// x's and a's 16-byte vectors of ``row`` that this lane holds
template <int NV, bool POS>
__device__ __forceinline__ void load_row(const bf16* __restrict__ x, const bf16* __restrict__ a, int row, int d,
                                         int T, int lane, uint4 (&xv)[NV], uint4 (&av)[NV]) {
  const size_t base = (size_t)row * d;
  const size_t abase = POS ? (size_t)(row % T) * d : base;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = (v * 32 + lane) * 8;
    if (c < d) {
      xv[v] = __ldg(reinterpret_cast<const uint4*>(x + base + c));
      av[v] = __ldg(reinterpret_cast<const uint4*>(a + abase + c));
    }
  }
}

template <int NV, bool POS, bool WRITE_S>
__global__ void __launch_bounds__(32 * WARPS)
    add_layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                          const bf16* __restrict__ gamma, const bf16* __restrict__ beta, bf16* __restrict__ s_out,
                          bf16* __restrict__ h_out, int rows, int d, int T, float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  uint4 g[NV] = {}, b[NV] = {};
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = (v * 32 + lane) * 8;
    if (c < d) {
      g[v] = __ldg(reinterpret_cast<const uint4*>(gamma + c));
      b[v] = __ldg(reinterpret_cast<const uint4*>(beta + c));
    }
  }
  const float inv_d = 1.0f / (float)d;
  uint4 xn[NV] = {}, an[NV] = {};
  if (row < rows) load_row<NV, POS>(x, a, row, d, T, lane, xn, an);
  for (; row < rows; row += stride) {
    uint4 sv[NV], av[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      sv[v] = xn[v];
      av[v] = an[v];
    }
    if (row + stride < rows) load_row<NV, POS>(x, a, row + stride, d, T, lane, xn, an);

    // s = bf16(x + a), kept as bf16 (to store) and as f32 (to normalise)
    float sf[NV][8];
    float sum = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if ((v * 32 + lane) * 8 < d) {
        float xf[8], af[8];
        unpack8(sv[v], xf);
        unpack8(av[v], af);
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&sv[v]);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(xf[2 * i] + af[2 * i], xf[2 * i + 1] + af[2 * i + 1]);
        unpack8(sv[v], sf[v]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += sf[v][i];
      }
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if ((v * 32 + lane) * 8 < d) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float t = sf[v][i] - mean;
          sq += t * t;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);

    const size_t base = (size_t)row * d;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * 8;
      if (c < d) {
        float gf[8], bf[8];
        unpack8(g[v], gf);
        unpack8(b[v], bf);
        uint4 o;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = __floats2bfloat162_rn(gf[2 * i] * (rstd * (sf[v][2 * i] - mean)) + bf[2 * i],
                                       gf[2 * i + 1] * (rstd * (sf[v][2 * i + 1] - mean)) + bf[2 * i + 1]);
        *reinterpret_cast<uint4*>(h_out + base + c) = o;
        if (WRITE_S) *reinterpret_cast<uint4*>(s_out + base + c) = sv[v];
      }
    }
  }
}

template <int NV, bool POS, bool WRITE_S>
int launch(const bf16* x, const bf16* a, const bf16* gamma, const bf16* beta, bf16* s, bf16* h, int rows, int d,
           int T, float eps, int device, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks an SM, the same on every card of one build
  cudaError_t err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, add_layer_norm_kernel<NV, POS, WRITE_S>,
                                                        32 * WARPS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  const int needed = (rows + WARPS - 1) / WARPS;
  const int grid = needed < sms * per_sm ? needed : sms * per_sm;
  add_layer_norm_kernel<NV, POS, WRITE_S><<<grid, 32 * WARPS, 0, stream>>>(x, a, gamma, beta, s, h, rows, d, T, eps);
  return (int)cudaGetLastError();
}

template <bool POS, bool WRITE_S>
int dispatch(const bf16* x, const bf16* a, const bf16* gamma, const bf16* beta, bf16* s, bf16* h, int rows, int d,
             int T, float eps, int device, cudaStream_t stream) {
  if (d <= 256) return launch<1, POS, WRITE_S>(x, a, gamma, beta, s, h, rows, d, T, eps, device, stream);
  if (d <= 512) return launch<2, POS, WRITE_S>(x, a, gamma, beta, s, h, rows, d, T, eps, device, stream);
  if (d <= 768) return launch<3, POS, WRITE_S>(x, a, gamma, beta, s, h, rows, d, T, eps, device, stream);
  return launch<4, POS, WRITE_S>(x, a, gamma, beta, s, h, rows, d, T, eps, device, stream);
}

}  // namespace

// s = bf16(x + a) and h = LN(s) * gamma + beta on ``stream`` of ``device``,
// one launch (the device made current for it, and the caller's restored).
// x, s and h are contiguous, 16-byte aligned [rows, d] bf16 device tensors,
// gamma and beta [d]; a is [rows, d] where ``table_rows`` is 0, else a
// [table_rows, d] table whose row r % table_rows row r of x takes; s null:
// s not written.  8 <= d <= 1024 with d % 8 == 0, rows >= 0.  Returns a
// cudaError_t (cudaErrorInvalidValue outside that envelope).
extern "C" int add_layer_norm(const void* x, const void* a, const void* gamma, const void* beta, void* s, void* h,
                              int rows, int d, int table_rows, float eps, int device, void* stream_ptr) {
  if (d < 8 || d > 1024 || d % 8 != 0 || rows < 0 || table_rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16 *xp = static_cast<const bf16*>(x), *ap = static_cast<const bf16*>(a);
  const bf16 *gp = static_cast<const bf16*>(gamma), *bp = static_cast<const bf16*>(beta);
  bf16 *sp = static_cast<bf16*>(s), *hp = static_cast<bf16*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  int rc;
  if (table_rows > 0)
    rc = sp ? dispatch<true, true>(xp, ap, gp, bp, sp, hp, rows, d, table_rows, eps, device, st)
            : dispatch<true, false>(xp, ap, gp, bp, sp, hp, rows, d, table_rows, eps, device, st);
  else
    rc = sp ? dispatch<false, true>(xp, ap, gp, bp, sp, hp, rows, d, 1, eps, device, st)
            : dispatch<false, false>(xp, ap, gp, bp, sp, hp, rows, d, 1, eps, device, st);
  if (current != device) cudaSetDevice(current);
  return rc;
}
