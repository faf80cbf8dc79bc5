// Short-sequence self-attention for Hopper (sm_90a):
//   o = softmax(q^T k / sqrt(dh)) v   on [BH, dh, T] bf16, no mask.
//
// Replaces the TPU kernel ops/pallas/attention.py::_kernel of the JAX
// package, entered through fused_attention_bdt.  The contract is the same:
// f32 logits and softmax, the probabilities rounded to v's dtype (bf16)
// before the product with v, f32 accumulation, output in bf16.
//
// What bounds it on this card.  Dual-path attention runs over chunks (DPTNet:
// T = 100 rows, T = S columns) with dh = 16 and a huge head count, so the
// work per head is tiny: 2 * T^2 * dh multiply-adds against 4 * dh * T bytes
// moved.  At dh = 16 that is T/4 FLOP per byte, far below the ~295 the card
// needs before the tensor cores are the limit, so the floor is the bytes:
// q, k and v read once and o written once.  The TPU kernel kept the whole
// [T, T] logits of a head in VMEM (which capped T at 1024); a thread block
// here keeps one tile of 64 queries and walks the keys in tiles of 64 with
// an online softmax, so no logits reach device memory and T has no cap.
//
// Layout.  q, k and v are read in the [BH, dh, T] layout the callers build
// (the tokens are contiguous, so a tile loads coalesced) straight into
// shared memory, where q is the col-major A operand, k the row-major B
// operand of q^T k and v the col-major B operand of P v.  Products are bf16
// WMMA 16x16x16 with f32 accumulation.  dh is zero-padded to a multiple of
// 16 (one k-step at dh = 16); ragged key tiles get -inf logits before the
// exponent and zero v rows.  The running output stays in shared memory in
// f32 and is rescaled per row by exp(m_old - m_new) before each P v product.
//
// One thread block of 4 warps per (head, tile of 64 queries); each warp owns
// 16 queries.  One launch a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int QT = 64;          // queries per thread block
constexpr int KT = 64;          // keys per step
constexpr int THREADS = 128;    // 4 warps x 16 queries
constexpr int LQ = QT + 8;      // bf16 row stride of q^T staged as [DP][LQ]
constexpr int LK = KT + 8;      // bf16 row stride of k, v ([DP][LK]) and P ([QT][LK])
constexpr int LS = KT + 4;      // f32 row stride of the logits [QT][LS]

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory bytes for a padded head width DP (a multiple of 16); every
// region is a multiple of 128 bytes, so each stays aligned for WMMA.
__host__ __device__ constexpr size_t smem_bytes(int DP) {
  return (size_t)DP * LQ * 2 + 2 * (size_t)DP * LK * 2 + (size_t)QT * LK * 2 +
         (size_t)QT * LS * 4 + (size_t)QT * (DP + 4) * 4 + 2 * QT * 4;
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int T, int dh, int DP,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LO = DP + 4;  // f32 row stride of the running output [QT][LO]
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [DP][LQ]: q^T, col-major A
  bf16* Ks = Qs + DP * LQ;                   // [DP][LK]: row-major B
  bf16* Vs = Ks + DP * LK;                   // [DP][LK]: v^T as col-major B
  bf16* Ps = Vs + DP * LK;                   // [QT][LK]: probabilities, row-major A
  float* Ss = reinterpret_cast<float*>(Ps + QT * LK);  // [QT][LS]: logits
  float* Os = Ss + QT * LS;                            // [QT][LO]: running output
  float* row_m = Os + QT * LO;                         // [QT]: running max
  float* row_l = row_m + QT;                           // [QT]: running sum

  const int bh = blockIdx.x, q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)bh * dh * T;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < DP * QT; i += THREADS) {
    const int d = i / QT, t = i % QT;
    Qs[d * LQ + t] = (d < dh && q0 + t < T) ? q[base + (size_t)d * T + q0 + t] : zero;
  }
  for (int i = tid; i < QT * DP; i += THREADS) Os[(i / DP) * LO + i % DP] = 0.f;
  if (tid < QT) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    for (int i = tid; i < DP * KT; i += THREADS) {
      const int d = i / KT, t = i % KT;
      const bool in = d < dh && k0 + t < T;
      const size_t at = base + (size_t)d * T + k0 + t;
      Ks[d * LK + t] = in ? k[at] : zero;
      Vs[d * LK + t] = in ? v[at] : zero;
    }
    __syncthreads();

    // logits of the warp's 16 queries against this key tile
    for (int n = 0; n < KT / 16; ++n) {
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < DP / 16; ++kk) {
        FragAc a;
        FragB b;
        wmma::load_matrix_sync(a, Qs + kk * 16 * LQ + warp * 16, LQ);
        wmma::load_matrix_sync(b, Ks + kk * 16 * LK + n * 16, LK);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * LS + n * 16, acc, LS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time, two keys a lane
    const int nvalid = min(KT, T - k0);
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float m_old = row_m[row];
      const float* srow = Ss + row * LS;
      const float s0 = lane < nvalid ? srow[lane] * scale : -INFINITY;
      const float s1 = lane + 32 < nvalid ? srow[lane + 32] * scale : -INFINITY;
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = expf(m_old - m_new);  // 0 on the first tile
      const float sum = warp_sum(p0 + p1);
      Ps[row * LK + lane] = __float2bfloat16(p0);
      Ps[row * LK + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < DP; d += 32) Os[row * LO + d] *= alpha;
      if (lane == 0) {
        row_m[row] = m_new;
        row_l[row] = row_l[row] * alpha + sum;
      }
    }
    __syncwarp();

    // running output += P v
    for (int n = 0; n < DP / 16; ++n) {
      Acc acc;
      wmma::load_matrix_sync(acc, Os + warp * 16 * LO + n * 16, LO, wmma::mem_row_major);
      for (int kk = 0; kk < KT / 16; ++kk) {
        FragA a;
        FragBc b;
        wmma::load_matrix_sync(a, Ps + warp * 16 * LK + kk * 16, LK);
        wmma::load_matrix_sync(b, Vs + n * 16 * LK + kk * 16, LK);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * LO + n * 16, acc, LO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = tid; i < dh * QT; i += THREADS) {
    const int d = i / QT, t = i % QT;
    if (q0 + t < T) o[base + (size_t)d * T + q0 + t] = __float2bfloat16(Os[t * LO + d] / row_l[t]);
  }
}

}  // namespace

// o = softmax(q^T k / sqrt(dh)) v on ``stream``, one launch.  q, k, v and o
// are contiguous [BH, dh, T] bf16 device tensors; 8 <= dh <= 256 with
// dh % 8 == 0, T >= 1.  Returns a cudaError_t.
extern "C" int attention_bdt(const void* q, const void* k, const void* v, void* o, int BH,
                             int dh, int T, void* stream_ptr) {
  const int DP = (dh + 15) / 16 * 16;
  const size_t smem = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (T + QT - 1) / QT);
  attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), T, dh, DP, 1.0f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}
