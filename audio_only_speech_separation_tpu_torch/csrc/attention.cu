// Short-sequence self-attention for Hopper (sm_90a):
//   o = softmax(q^T k / sqrt(dh)) v   per head, bf16, no mask,
// in two operand layouts, one kernel body:
// - [BH, dh, T] (attention_bdt): q, k, v and o each a head's contiguous
//   [dh, T] slab, the TPU kernel's layout;
// - packed (attention_packed): q, k and v read straight from the in-
//   projection [B, T, 3E] (head j of sequence b: token t's q at
//   [b, t, j*dh : (j+1)*dh], its k at +E, its v at +2E), o written as
//   [B, T, E] with head j in columns j*dh : (j+1)*dh.
//
// Replaces the TPU kernel ops/pallas/attention.py::_kernel of the JAX
// package, entered through fused_attention_bdt.  The contract is the same:
// f32 logits and softmax, the probabilities rounded to v's dtype (bf16)
// before the product with v, f32 accumulation, output in bf16.  The keys
// are walked with an online softmax, so the probabilities are rounded
// before their normalisation (by the f32 sum of the unrounded ones).
//
// What bounds it on this card.  Dual-path attention runs over chunks (DPTNet:
// T = 100 rows, T = S columns) with dh = 16 and a huge head count, so the
// work per head is tiny: 2 * T^2 * dh multiply-adds against 4 * dh * T bytes
// moved.  At dh = 16 that is T/4 FLOP per byte, far below the ~295 the card
// needs before the tensor cores are the limit, so the floor is the bytes:
// q, k and v read once and o written once.  The TPU kernel kept the whole
// [T, T] logits of a head in VMEM (which capped T at 1024); here no logits
// reach memory at all, and T has no cap.
//
// What the design does about it, in the FlashAttention-2 manner on
// mma.sync m16n8k16:
// - One thread block per (head, block of up to 128 queries), one warp per
//   16 queries: T = 100 takes 7 warps (112 rows), T = 42 three (48).  The
//   block's q, and the head's k and v in chunks of up to 128 keys (64 at
//   dh > 128; so for T <= 128, as at the B=8 dual-path shapes, one block
//   and one chunk a head, and k and v are read once), are staged in shared
//   memory, zero-padded to multiples of 16 in both dimensions (q to the
//   block's warps).
//   [BH, dh, T]: as [dh][tokens] tiles, read from the head's contiguous
//   [dh, T] slab with 16-byte loads along the flat slab (16-byte aligned as
//   dh % 8 == 0; its rows are not where T % 8 != 0, which rules out
//   cp.async into 16-byte tile rows), each element placed in its tile row.
//   Packed: as [tokens][dh] tiles, each token row (dh contiguous bf16 at a
//   row stride of 3E, 16-byte aligned as E % 8 == 0) copied by 16-byte
//   cp.async at any T, the padding by the copies' zero fill; the tiles are
//   as deep as the block's warps and the head's keys need, so the short
//   heads of a dual-path inter pass keep more blocks on an SM.
// - The layouts are met with ldmatrix.  [BH, dh, T]: .trans gives q^T as
//   the A and k as the B operand of q^T k, the plain form v as the B
//   operand of P v.  Packed: the plain form gives q and k, .trans v.  Every
//   tile row is padded by 16 bytes, so ldmatrix's eight rows fall in
//   distinct banks.
// - S = q^T k lives in the accumulator registers, 64 keys a step (16-key
//   groups past the chunk's end skipped, keys past T masked in registers);
//   the row max and sum take two quad shuffles; the exponent is exp2f with
//   log2(e)/sqrt(dh) folded into one scale.
// - P's accumulators are re-packed to bf16 in registers as the A fragment
//   of P v (the C layout of S over 16 keys is the A layout of P): no shared
//   memory.  The output accumulators stay in registers and are rescaled in
//   place; the row sums stay per thread and are reduced once at the end.
// - The output is normalised once and written through shared memory, each
//   warp into its own query rows (columns, [BH, dh, T]) of the q tile.
//   [BH, dh, T]: the [dh, T] stores are coalesced after a block barrier.
//   Packed: each warp then stores its token rows of [B, T, E] 16 bytes a
//   lane, with no block barrier.
// - Two barriers a chunk: one before its k and v are in place, one before
//   they are replaced (none within a chunk).
// The first port's kernel (elementwise loads with div/mod, k and v reloaded
// by every 64-query block, logits and the running output through shared
// memory as f32, a serial row-by-row softmax, three barriers a key tile)
// took 0.105 ms on the device at [1344, 16, 100].
//
// One launch a call; dh is rounded up to DP = 16, 32, 64, 128 or 256, one
// instantiation each a layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum class Layout { BDT, PACKED };

constexpr int QB = 128;     // queries per thread block at most (8 warps x 16)
constexpr int LQ = QB + 8;  // bf16 row stride of the [BH, dh, T] q tile [DP][LQ], also the output transpose
constexpr int KS = 64;      // keys a step of the online softmax

// keys staged at a time for a padded head width DP
__host__ __device__ constexpr int chunk_keys(int DP) { return DP <= 128 ? 128 : 64; }

// bf16 row stride of the packed layout's [tokens][DP] tiles
__host__ __device__ constexpr int packed_ld(int DP) { return DP + 8; }

// Dynamic shared memory of a block of ``warps`` warps over T tokens: fixed
// [DP][tokens] tiles for [BH, dh, T]; packed, [tokens][DP] tiles of the
// block's query rows and of one chunk's keys.
template <int DP, Layout L>
size_t smem_bytes(int warps, int T) {
  if (L == Layout::BDT) return ((size_t)DP * LQ + 2 * (size_t)DP * (chunk_keys(DP) + 8)) * 2;
  const int krows = chunk_keys(DP) < ((T + 15) & ~15) ? chunk_keys(DP) : ((T + 15) & ~15);
  return ((size_t)16 * warps + 2 * (size_t)krows) * packed_ld(DP) * 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// ``valid`` is false (``src`` must still be a valid address)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// bf16(lo) in the low half, bf16(hi) in the high half: an mma A register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Tokens [c0, c0 + n) of rows [0, dh) of a head's [dh, T] slab into
// dst[DP][ld] at columns [0, n); zeros in columns [n, ncols) of those rows
// and in columns [0, ncols) of rows [dh, DP).  16-byte loads along the
// flat slab: VPR of them cover a row's run of at most VPR * 8 - 8 tokens
// at any alignment.
template <int VPR>
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* __restrict__ slab, int T, int dh,
                                      int DP, int c0, int n, int ncols, int tid, int nthr) {
  for (int i = tid; i < dh * VPR; i += nthr) {
    const int d = i / VPR, j = i - d * VPR;
    const int start = d * T + c0;            // flat index of (d, c0)
    const int v = (start & ~7) + 8 * j;      // this load's first element
    if (v >= start + n) continue;
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(slab + v));
    const bf16* e = reinterpret_cast<const bf16*>(&w);
    bf16* row = dst + d * ld;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = v + k - start;
      if (col >= 0 && col < n) row[col] = e[k];
    }
  }
  const bf16 zero = __float2bfloat16(0.f);
  const int pad = ncols - n;
  for (int i = tid; i < dh * pad; i += nthr) {
    const int d = i / pad;
    dst[d * ld + n + (i - d * pad)] = zero;
  }
  for (int i = tid; i < (DP - dh) * ncols; i += nthr) {
    const int d = i / ncols;
    dst[(dh + d) * ld + (i - d * ncols)] = zero;
  }
}

// Token rows [0, n) (dh bf16 each, ``ld`` apart from ``src`` on) into
// dst[rows][packed_ld(DP)] at columns [0, dh), by 16-byte cp.async; zeros
// in columns [dh, DP) and in rows [n, rows).  The caller waits.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int ld, int n, int rows,
                                           int dh, int tid, int nthr) {
  constexpr int CPR = DP / 8;  // 16-byte pieces a tile row
  for (int i = tid; i < rows * CPR; i += nthr) {
    const int r = i / CPR, c = i - r * CPR;
    const bool valid = r < n && 8 * c < dh;
    cp_async16(dst + r * packed_ld(DP) + 8 * c, valid ? src + (size_t)r * ld + 8 * c : src, valid);
  }
}

// ``heads`` is read in the packed layout only (B * heads = gridDim.x).
template <int DP, Layout L>
__global__ void __launch_bounds__(256)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 bf16* __restrict__ o, int T, int dh, int heads, float scale_log2) {
  constexpr bool PK = L == Layout::PACKED;
  constexpr int KC = chunk_keys(DP);
  constexpr int LQT = PK ? packed_ld(DP) : LQ;      // row stride of the q tile
  constexpr int LK = PK ? packed_ld(DP) : KC + 8;   // row stride of the k and v tiles
  constexpr int NO = DP / 8;  // n-tiles of the output (8 of dh each)
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x, q0 = blockIdx.y * QB, nq = min(QB, T - q0);
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;  // accumulator row g (and g + 8), columns 2qd, 2qd + 1
  const int qrows = 16 * (nthr / 32);
  // [BH, dh, T]: Qs [DP][LQ] (q of the block, then the output), Ks and Vs
  // [DP][LK].  Packed: Qs [qrows][LQT], Ks and Vs [krows][LK].
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + (PK ? qrows * LQT : DP * LQ);
  bf16* Vs = Ks + (PK ? min(KC, (T + 15) & ~15) * LK : DP * LK);
  // packed: sequence b, head hj; the token step of the input and of o
  const int b = PK ? bh / heads : bh, hj = bh - b * heads, E = heads * dh, ld = 3 * E;
  size_t base;  // the head's first element of q, k and v
  if constexpr (PK) {
    base = (size_t)b * T * ld + (size_t)hj * dh;
    stage_rows<DP>(Qs, q + base + (size_t)q0 * ld, ld, nq, qrows, dh, tid, nthr);
  } else {
    base = (size_t)bh * dh * T;
    stage<QB / 8 + 1>(Qs, LQ, q + base, T, dh, DP, q0, nq, qrows, tid, nthr);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8
  const bf16* qw = Qs + warp * 16 * (PK ? LQT : 1);  // this warp's 16 queries

  for (int c0 = 0; c0 < T; c0 += KC) {
    const int nk = min(KC, T - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the previous chunk
    if constexpr (PK) {
      stage_rows<DP>(Ks, k + base + (size_t)c0 * ld, ld, nk, (nk + 15) & ~15, dh, tid, nthr);
      stage_rows<DP>(Vs, v + base + (size_t)c0 * ld, ld, nk, (nk + 15) & ~15, dh, tid, nthr);
      cp_async_wait_all();
    } else {
      stage<KC / 8 + 1>(Ks, LK, k + base, T, dh, DP, c0, nk, (nk + 15) & ~15, tid, nthr);
      stage<KC / 8 + 1>(Vs, LK, v + base, T, dh, DP, c0, nk, (nk + 15) & ~15, tid, nthr);
    }
    __syncthreads();  // q (first chunk), k and v in place

    for (int s0 = 0; s0 < nk; s0 += KS) {
      // logits of the warp's 16 queries against keys s0 .. s0 + 63 of the
      // chunk: n-tiles of 8 keys, two per 16-key group
      float s[KS / 8][4];
#pragma unroll
      for (int j = 0; j < KS / 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
        if (s0 + 16 * j < nk) {
#pragma unroll
          for (int ks = 0; ks < DP / 16; ++ks) {
            uint32_t a[4], b[4];
            if constexpr (PK) {
              ldsm_x4(a, qw + (lane & 15) * LQT + ks * 16 + (lane >> 4) * 8);
              ldsm_x4(b, Ks + (s0 + 16 * j + (lane >> 4) * 8 + (lane & 7)) * LK + ks * 16 +
                             ((lane >> 3) & 1) * 8);
            } else {
              ldsm_x4_trans(a, qw + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * LQ + ((lane >> 3) & 1) * 8);
              ldsm_x4_trans(b, Ks + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LK + s0 + 16 * j +
                                   (lane >> 4) * 8);
            }
            mma(s[2 * j], a, b[0], b[1]);
            mma(s[2 * j + 1], a, b[2], b[3]);
          }
        }
      }
      // scale into log2 units, mask keys past the chunk, new row maxima
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int jt = 0; jt < KS / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + 8 * jt + 2 * qd + (e & 1);
          s[jt][e] = key < nk ? s[jt][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[jt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_run[r] - mx[r]);  // 0 on the first step
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      // P = exp2(S - m) by 16-key groups: summed unrounded, rounded to bf16
      // as the A fragment of P v
#pragma unroll
      for (int j = 0; j < KS / 16; ++j) {
        if (s0 + 16 * j < nk) {
          float p[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2f(s[2 * j][e] - mx[e >> 1]);
            p[4 + e] = exp2f(s[2 * j + 1][e] - mx[e >> 1]);
          }
          l_run[0] += p[0] + p[1] + p[4] + p[5];
          l_run[1] += p[2] + p[3] + p[6] + p[7];
          const uint32_t a[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]), pack_bf16(p[4], p[5]),
                                 pack_bf16(p[6], p[7])};
#pragma unroll
          for (int n = 0; n < NO / 2; ++n) {  // 16 columns of dh at a time
            uint32_t b[4];
            if constexpr (PK)
              ldsm_x4_trans(b, Vs + (s0 + 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * LK + n * 16 +
                                   (lane >> 4) * 8);
            else
              ldsm_x4(b, Vs + (n * 16 + (lane >> 4) * 8 + (lane & 7)) * LK + s0 + 16 * j + ((lane >> 3) & 1) * 8);
            mma(acc[2 * n], a, b[0], b[1]);
            mma(acc[2 * n + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }

  // normalise, and write into this warp's own queries of the q tile (no
  // other warp reads them)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  __syncwarp();
  if constexpr (PK) {
    bf16* ow = Qs + warp * 16 * LQT;  // [16][LQT]: the warp's token rows
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(ow + (g + 8 * r) * LQT + 8 * n + 2 * qd) =
            pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    __syncwarp();
    // the warp's rows of o [B, T, E]: dh contiguous bf16 each, 16 bytes a lane
    constexpr int CPR = DP / 8;
    const int rows = min(16, nq - warp * 16);
    const size_t obase = ((size_t)b * T + q0 + warp * 16) * E + (size_t)hj * dh;
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR, c = i - r * CPR;
      if (r < rows && 8 * c < dh)
        *reinterpret_cast<uint4*>(o + obase + (size_t)r * E + 8 * c) =
            *reinterpret_cast<const uint4*>(ow + r * LQT + 8 * c);
    }
  } else {
    bf16* ow = Qs + warp * 16;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * qd + (e & 1);
        if (col < dh) ow[col * LQ + g + 8 * (e >> 1)] = __float2bfloat16(acc[n][e] * inv[e >> 1]);
      }
    __syncthreads();
    // row d of the block's output is nq contiguous tokens in o
    for (int d = warp; d < dh; d += nthr / 32)
      for (int c = lane; c < nq; c += 32) o[base + (size_t)d * T + q0 + c] = Qs[d * LQ + c];
  }
}

template <int DP, Layout L>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int dh, int T, int heads,
           cudaStream_t stream) {
  const int warps = (T + 15) / 16 < QB / 16 ? (T + 15) / 16 : QB / 16;
  const size_t smem = smem_bytes<DP, L>(warps, T);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<DP, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (T + QB - 1) / QB);
  attention_kernel<DP, L><<<grid, 32 * warps, smem, stream>>>(q, k, v, o, T, dh, heads,
                                                             1.4426950408889634f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

template <Layout L>
int dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int dh, int T, int heads,
             cudaStream_t s) {
  if (dh <= 16) return launch<16, L>(q, k, v, o, BH, dh, T, heads, s);
  if (dh <= 32) return launch<32, L>(q, k, v, o, BH, dh, T, heads, s);
  if (dh <= 64) return launch<64, L>(q, k, v, o, BH, dh, T, heads, s);
  if (dh <= 128) return launch<128, L>(q, k, v, o, BH, dh, T, heads, s);
  return launch<256, L>(q, k, v, o, BH, dh, T, heads, s);
}

}  // namespace

// o = softmax(q^T k / sqrt(dh)) v on ``stream``, one launch.  q, k, v and o
// are contiguous, 16-byte aligned [BH, dh, T] bf16 device tensors;
// 8 <= dh <= 256 with dh % 8 == 0, T >= 1.  Returns a cudaError_t.
extern "C" int attention_bdt(const void* q, const void* k, const void* v, void* o, int BH,
                             int dh, int T, void* stream_ptr) {
  return dispatch<Layout::BDT>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                               static_cast<const bf16*>(v), static_cast<bf16*>(o), BH, dh, T, 1,
                               static_cast<cudaStream_t>(stream_ptr));
}

// The same per head of the packed in-projection, one launch: qkv a
// contiguous, 16-byte aligned [B, T, 3 * heads * dh] bf16 device tensor
// (q, k, v of head j in columns j*dh, E + j*dh, 2E + j*dh), o a contiguous,
// 16-byte aligned [B, T, heads * dh] one; 8 <= dh <= 256 with dh % 8 == 0,
// T >= 1.  Returns a cudaError_t.
extern "C" int attention_packed(const void* qkv, void* o, int B, int heads, int dh, int T,
                                void* stream_ptr) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const size_t E = (size_t)heads * dh;
  return dispatch<Layout::PACKED>(q, q + E, q + 2 * E, static_cast<bf16*>(o), B * heads, dh, T, heads,
                                  static_cast<cudaStream_t>(stream_ptr));
}
