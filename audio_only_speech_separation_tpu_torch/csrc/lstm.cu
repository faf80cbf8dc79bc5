// (Bi)LSTM recurrences for Hopper (sm_90a), torch gate order i, f, g, o:
//
//   lstm_recurrence  gates pre-projected: xw [T, D, B, 4H] -> h [T, D, B, H]
//                    (the backward direction comes pre-reversed in time)
//   lstm_resident    the input projection inside: x [B, T, Din] ->
//                    h [T, D, B, H], both directions time-aligned
//
// They replace the TPU kernels ops/pallas/lstm.py::_kernel (through
// fused_bilstm) and ::_res_kernel (through resident_bilstm) of the JAX
// package, and round as those do:
//   lstm_recurrence  gates = f32(bf16(xw + bf16(h @ W_hh)))
//   lstm_resident    gates = f32(bf16(bf16(x @ W_ih + b) + bf16(h @ W_hh)))
// with f32 accumulation, sigmoid and tanh in f32, c = bf16(f*c + i*g) and
// h = bf16(o * tanh(f*c + i*g)).  The state starts at zero.
//
// What bounds lstm_recurrence (K5) on this card.  The recurrence is serial
// in t: each step is a [16, H] x [H, 4H] product per batch tile that cannot
// start before the previous step's h exists, so the time is T steps of
// latency (a shared-memory product, two barriers and the gate math), not
// bytes or FLOPs.  At the dual-path shapes (H = 128) the whole call moves a
// few MB and does a few GFLOP, microseconds of either.  Its design keeps the
// recurrence on chip: a thread block owns one direction and 16 batch rows
// for all T steps; W_hh of its direction sits in shared memory when it fits
// (128 KB bf16 at H = 128, with the 227 KB limit raised by
// cudaFuncSetAttribute), otherwise it is read from L2; h stays in shared
// memory and c in registers; the gate inputs xw of step t are the only
// per-step reads.  Products are bf16 WMMA 16x16x16.  Rows past B are
// masked: their h is zero and their outputs are not written.  Nothing here
// tunes its serial loop yet; at batch 1 an inter-chunk pass has 7 blocks a
// direction.  One launch a call; the grid is (batch tiles, directions).
// (lstm_kernel<true> is the first port's resident form, which lstm_resident
// no longer launches.)
//
// lstm_resident (K6) is a kernel of its own, described where it starts
// below.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <array>
#include <map>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BT = 16;          // batch rows per thread block (one WMMA row tile)
constexpr int THREADS = 256;    // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int MAXC = 16;        // cells per thread: BT * H / THREADS, H <= 256
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block can use

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Shared-memory layout, in bytes from the start; each region is a multiple
// of 128 bytes.  Gh/Gx: f32 [BT][4H + 4] products; Hs: bf16 [BT][H + 8];
// Xs: bf16 [BT][Din + 8] (resident form); Ws: bf16 [H][4H + 8] (when W_hh is
// kept in shared memory).
struct Layout {
  size_t gx, hs, xs, ws, total_without_w, total;
};

__host__ __device__ inline Layout layout(int H, int Din, bool proj) {
  Layout L;
  const size_t g = (size_t)BT * (4 * H + 4) * 4;
  L.gx = g;
  L.hs = L.gx + (proj ? g : 0);
  L.xs = L.hs + (size_t)BT * (H + 8) * 2;
  L.ws = L.xs + (proj ? (size_t)BT * (Din + 8) * 2 : 0);
  L.total_without_w = L.ws;
  L.total = L.ws + (size_t)H * (4 * H + 8) * 2;
  return L;
}

template <bool kProj>
__global__ void __launch_bounds__(THREADS)
lstm_kernel(const bf16* __restrict__ xw, const bf16* __restrict__ x,
            const bf16* __restrict__ w_ih, const bf16* __restrict__ w_hh,
            const float* __restrict__ bias, bf16* __restrict__ out, int T, int D, int B, int H,
            int Din, int w_in_smem) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 4 * H, LG = G + 4, LH = H + 8, LX = Din + 8, LW = G + 8;
  const Layout L = layout(H, Din, kProj);
  float* Gh = reinterpret_cast<float*>(smem);              // h @ W_hh
  float* Gx = reinterpret_cast<float*>(smem + L.gx);       // x @ W_ih (resident form)
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* Ws = reinterpret_cast<bf16*>(smem + L.ws);

  const int d = blockIdx.y, b0 = blockIdx.x * BT;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bf16 zero = __float2bfloat16(0.f);
  const bf16* Whh = w_hh + (size_t)d * H * G;
  const bf16* Wih = kProj ? w_ih + (size_t)d * Din * G : nullptr;
  const float* bd = kProj ? bias + (size_t)d * G : nullptr;

  if (w_in_smem) {
    for (int i = tid; i < H * G / 8; i += THREADS) {
      const int row = (i * 8) / G, col = (i * 8) % G;
      *reinterpret_cast<uint4*>(Ws + (size_t)row * LW + col) =
          *reinterpret_cast<const uint4*>(Whh + (size_t)i * 8);
    }
  }
  const bf16* Wb = w_in_smem ? Ws : Whh;
  const int ldw = w_in_smem ? LW : G;
  for (int i = tid; i < BT * LH; i += THREADS) Hs[i] = zero;

  const int ncell = BT * H / THREADS;
  float c[MAXC];
#pragma unroll
  for (int e = 0; e < MAXC; ++e) c[e] = 0.f;

  for (int t = 0; t < T; ++t) {
    const int ti = (kProj && d == 1) ? T - 1 - t : t;
    if (kProj) {
      for (int i = tid; i < BT * Din; i += THREADS) {
        const int r = i / Din, j = i % Din;
        Xs[r * LX + j] = b0 + r < B ? x[((size_t)(b0 + r) * T + ti) * Din + j] : zero;
      }
    }
    __syncthreads();  // h of the previous step (and this step's x rows) in place

    for (int n = warp; n < G / 16; n += NWARPS) {
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < H / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, Hs + kk * 16, LH);
        wmma::load_matrix_sync(b, Wb + (size_t)kk * 16 * ldw + n * 16, ldw);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Gh + n * 16, acc, LG, wmma::mem_row_major);
      if (kProj) {
        Acc ax;
        wmma::fill_fragment(ax, 0.f);
        for (int kk = 0; kk < Din / 16; ++kk) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, Xs + kk * 16, LX);
          wmma::load_matrix_sync(b, Wih + (size_t)kk * 16 * G + n * 16, G);
          wmma::mma_sync(ax, a, b, ax);
        }
        wmma::store_matrix_sync(Gx + n * 16, ax, LG, wmma::mem_row_major);
      }
    }
    __syncthreads();  // products in place; every read of Hs done

#pragma unroll
    for (int e = 0; e < MAXC; ++e) {
      if (e >= ncell) break;
      const int idx = tid + e * THREADS;
      const int r = idx / H, j = idx % H;
      const int b = b0 + r;
      const bool valid = b < B;
      float gate[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * H + j;
        const float hw = round_bf16(Gh[r * LG + col]);
        float in;
        if (kProj) {
          in = round_bf16(Gx[r * LG + col] + bd[col]);
        } else {
          in = valid ? __bfloat162float(xw[(((size_t)t * D + d) * B + b) * G + col]) : 0.f;
        }
        gate[q] = round_bf16(in + hw);
      }
      const float ig = sigmoid(gate[0]), fg = sigmoid(gate[1]);
      const float gg = tanhf(gate[2]), og = sigmoid(gate[3]);
      const float c32 = fg * c[e] + ig * gg;
      const bf16 h = __float2bfloat16(og * tanhf(c32));
      c[e] = valid ? round_bf16(c32) : 0.f;
      Hs[r * LH + j] = valid ? h : zero;
      if (valid) out[(((size_t)ti * D + d) * B + b) * H + j] = h;
    }
  }
}

template <bool kProj>
int launch(const bf16* xw, const bf16* x, const bf16* w_ih, const bf16* w_hh, const float* bias,
           bf16* out, int T, int D, int B, int H, int Din, cudaStream_t stream) {
  const Layout L = layout(H, Din, kProj);
  const int w_in_smem = L.total <= SMEM_LIMIT;
  const size_t smem = w_in_smem ? L.total : L.total_without_w;
  cudaError_t err = cudaFuncSetAttribute(lstm_kernel<kProj>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, D);
  lstm_kernel<kProj><<<grid, THREADS, smem, stream>>>(xw, x, w_ih, w_hh, bias, out, T, D, B, H,
                                                      Din, w_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// h [T, D, B, H] from pre-projected gates xw [T, D, B, 4H] and w_hh
// [D, H, 4H], all contiguous bf16 device tensors; H % 16 == 0, H <= 256.
// One launch on ``stream``.  Returns a cudaError_t.
extern "C" int lstm_recurrence(const void* xw, const void* w_hh, void* out, int T, int D, int B,
                               int H, void* stream_ptr) {
  return launch<false>(static_cast<const bf16*>(xw), nullptr, nullptr,
                       static_cast<const bf16*>(w_hh), nullptr, static_cast<bf16*>(out), T, D,
                       B, H, 0, static_cast<cudaStream_t>(stream_ptr));
}

// ---------------------------------------------------------------------------
// lstm_resident (K6), redesigned for Hopper.  Replaces
// ops/pallas/lstm.py::_res_kernel of the JAX package (through
// resident_bilstm).
//
// What bounds it on this card.  Each of the T steps is a [16, H] x [H, 4H]
// product, the gate math and a block-wide hand-over of h; nothing of step
// t + 1 but its input product can start before h_t exists.  So the time is
// T times the latency of one step, far above the bytes (a few MB) and the
// FLOPs (a few GFLOP) of the call.  The first port spent 13-14 us a step:
// x read element by element from global memory, W_ih read from L2 inside
// the step, both products stored to shared memory as f32 and read back by
// the gate phase (WMMA fragments are opaque), the bias re-read for every
// cell, two barriers and 16 cells of serial gate math a thread.
//
// What the design does about it.
// - mma.sync m16n8k16 with its documented fragment layout.  The wrapper
//   packs W_ih and W_hh in fragment order with the gate columns
//   interleaved (ops/kernels/lstm.py::pack_gate_fragments): n-tile 2p holds
//   (i, f) and n-tile 2p + 1 holds (g, o) of hidden units 4p .. 4p + 3, so a
//   thread's accumulators hold all four gates of its own cells (two rows,
//   one unit, for each pair p of the warp).  The gate math reads registers:
//   no shared-memory round trip of the products.  A lane's B fragment is one
//   8-byte word, and a warp's 32 words are contiguous.
// - A step is spread over a thread-block cluster of 1, 2 or 4 CTAs (as many
//   as fit on the card at once for the call's shape): each CTA owns 1/cl of
//   the gate pairs and its slice of the packed weights, and writes its part
//   of h_t into every CTA's h buffer through distributed shared memory.
//   Where a CTA has at most 256 threads (H <= 128), each warp holds its
//   W_hh fragments in registers; otherwise W_hh, and W_ih always, sit in
//   shared memory where they fit (W_hh first), else are read from L2 in
//   the same order.
// - One barrier a step, the cluster's, split in two: h is double-buffered,
//   and between arriving and waiting each CTA computes the next step's
//   x(t + 1) @ W_ih, which needs nothing of h_t.  The x rows are
//   prefetched 3 steps ahead with cp.async into a 4-slot ring.  The bias
//   sits in registers.
// - 2 gate pairs (8 columns of each of the four gates) per warp up to H 128,
//   4 pairs per warp above.
// The rounding is the first port's and the TPU kernel's: gates =
// f32(bf16(bf16(x W_ih + b) + bf16(h W_hh))), c = bf16(f c + i g),
// h = bf16(o tanh(f c + i g)); sigmoid and tanh are f32 through __expf
// (a few ulp, far below the bf16 rounding that follows).  Rows past B run
// on zero x and are neither kept in h nor stored.  One launch a call.
// ---------------------------------------------------------------------------

namespace {

constexpr int K6_ROWS = 16;  // batch rows per thread block (the mma M)
constexpr int K6_NX = 4;     // slots of the x ring (prefetch 3 steps ahead)

struct K6Layout {
  size_t hbuf, xring, whh, wih, total;
};

// Shared memory in bytes of a CTA of a cl-CTA cluster: h [2][16][H + 8]
// bf16, x [NX][16][Din + 8] bf16, then the CTA's 1/cl of the packed W_hh
// and W_ih columns where they fit.
__host__ __device__ inline K6Layout k6_layout(int H, int Din, int cl, bool whh_smem,
                                              bool wih_smem) {
  K6Layout L;
  L.hbuf = 0;
  L.xring = L.hbuf + (size_t)2 * K6_ROWS * (H + 8) * 2;
  L.whh = L.xring + (size_t)K6_NX * K6_ROWS * (Din + 8) * 2;
  L.whh = (L.whh + 127) / 128 * 128;
  L.wih = L.whh + (whh_smem ? (size_t)H * 4 * H * 2 / cl : 0);
  L.total = L.wih + (wih_smem ? (size_t)Din * 4 * H * 2 / cl : 0);
  return L;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[j] = A[16][K] @ (n-tile nt0 + j of a packed weight), A in shared
// memory with row stride lda (bf16), the weight in fragment order:
// w[(nt * K/16 + ks) * 32 + lane].
template <int NT>
__device__ __forceinline__ void k6_product(float (&acc)[NT][4], const bf16* A, int lda, int K,
                                           const uint2* w, int nt0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int ks_n = K / 16;
  const bf16* arow = A + (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll 2
  for (int ks = 0; ks < ks_n; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, arow + ks * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, w[((size_t)(nt0 + j) * ks_n + ks) * 32 + lane]);
  }
}

// The same with the warp's B fragments in registers: wr[j][ks], K <= 16 * KSR.
template <int NT, int KSR>
__device__ __forceinline__ void k6_product_regs(float (&acc)[NT][4], const bf16* A, int lda, int K,
                                                const uint2 (&wr)[NT][KSR], int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* arow = A + (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KSR; ++ks) {
    if (ks < K / 16) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + ks * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, wr[j][ks]);
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// sigmoid and tanh in f32 through __expf (a few ulp; the results round to
// bf16)
__device__ __forceinline__ float k6_sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float k6_tanh(float x) { return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x)); }

// One cluster of cl thread blocks per (16 batch rows, direction); CTA k of
// the cluster owns gate pairs k*P/cl .. (k+1)*P/cl - 1 (P = H/4; 16 columns
// and 4 hidden units a pair) with 32 * P / (cl * PPW) threads, warp w pairs
// w*PPW .. w*PPW + PPW - 1 of those.  Each CTA writes its part of h_t into
// every CTA's h buffer (distributed shared memory), then arrives at the
// cluster barrier, computes the next step's input product, and waits.
// kRegW: the warp's W_hh fragments live in registers (H <= 128, at most
// 256 threads a CTA).
template <int PPW, bool kRegW>
__global__ void __launch_bounds__(kRegW ? 256 : 512)
lstm_resident_kernel(const bf16* __restrict__ x, const uint2* __restrict__ wih_p,
                     const uint2* __restrict__ whh_p, const float* __restrict__ bias,
                     bf16* __restrict__ out, int T, int D, int B, int Din, int H, int cl,
                     int whh_smem, int wih_smem) {
  constexpr int NT = 2 * PPW;          // n-tiles a warp owns
  constexpr int KSR = kRegW ? 8 : 1;   // k-steps of W_hh held in registers
  extern __shared__ __align__(128) unsigned char smem[];
  const K6Layout L = k6_layout(H, Din, cl, whh_smem, wih_smem);
  const int LH = H + 8, LX = Din + 8, G = 4 * H;
  bf16* hbuf = reinterpret_cast<bf16*>(smem + L.hbuf);
  bf16* xring = reinterpret_cast<bf16*>(smem + L.xring);
  const int rank = cl > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const int d = blockIdx.y, b0 = (blockIdx.x / cl) * K6_ROWS;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int pair0 = rank * (H / 4 / cl);  // first gate pair of this CTA
  const int nt0 = warp * NT;              // first n-tile of this warp, within the CTA's

  // this CTA's n-tiles of the packed weights of direction d: in registers,
  // or in shared memory where they fit, or read from L2
  const size_t whh_words = (size_t)H * G / 4 / cl, wih_words = (size_t)Din * G / 4 / cl;
  const uint2* whh = whh_p + (d * cl + rank) * whh_words;
  const uint2* wih = wih_p + (d * cl + rank) * wih_words;
  uint2 wr[NT][KSR];
  if (kRegW) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int ks = 0; ks < KSR; ++ks)
        wr[j][ks] = ks < H / 16 ? whh[((size_t)(nt0 + j) * (H / 16) + ks) * 32 + lane] : make_uint2(0u, 0u);
  }
  if (whh_smem) {
    uint4* dst = reinterpret_cast<uint4*>(smem + L.whh);
    const uint4* src = reinterpret_cast<const uint4*>(whh);
    for (size_t i = tid; i < whh_words / 2; i += nthr) dst[i] = src[i];
    whh = reinterpret_cast<const uint2*>(smem + L.whh);
  }
  if (wih_smem) {
    uint4* dst = reinterpret_cast<uint4*>(smem + L.wih);
    const uint4* src = reinterpret_cast<const uint4*>(wih);
    for (size_t i = tid; i < wih_words / 2; i += nthr) dst[i] = src[i];
    wih = reinterpret_cast<const uint2*>(smem + L.wih);
  }
  // h_{-1} = 0, and zero x rows past B in every slot (rows < B are only
  // ever written by cp.async, so nothing races with these stores)
  const int rows = min(K6_ROWS, B - b0), vpr = Din / 8;
  for (int i = tid; i < 2 * K6_ROWS * LH; i += nthr) hbuf[i] = __float2bfloat16(0.f);
  for (int i = tid; i < K6_NX * (K6_ROWS - rows) * LX; i += nthr) {
    const int slot = i / ((K6_ROWS - rows) * LX), rest = i - slot * (K6_ROWS - rows) * LX;
    xring[(slot * K6_ROWS + rows) * LX + rest] = __float2bfloat16(0.f);
  }
  // every CTA's h buffer, this CTA's first
  bf16* hbufs[4] = {hbuf, hbuf, hbuf, hbuf};
  if (cl > 1) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    for (int k = 1; k < cl; ++k) hbufs[k] = cluster.map_shared_rank(hbuf, (rank + k) % cl);
  }

  auto fetch_x = [&](int s) {  // x rows of step s into slot s % NX
    if (s < T) {
      const int ti = d == 1 ? T - 1 - s : s;
      bf16* slot = xring + (s % K6_NX) * K6_ROWS * LX;
      for (int i = tid; i < rows * vpr; i += nthr) {
        const int r = i / vpr, c = (i - r * vpr) * 8;
        cp_async16(slot + r * LX + c, x + ((size_t)(b0 + r) * T + ti) * Din + c);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < K6_NX - 1; ++s) fetch_x(s);

  // this thread's cells: unit 4 (pair0 + warp*PPW + j) + lane % 4 for each
  // pair j of the warp, rows r0 and r0 + 8
  const int r0 = lane >> 2, q = lane & 3;
  float bq[PPW][4], c[PPW][2];
#pragma unroll
  for (int j = 0; j < PPW; ++j) {
    const int u = 4 * (pair0 + warp * PPW + j) + q;
#pragma unroll
    for (int g = 0; g < 4; ++g) bq[j][g] = bias[(size_t)d * G + g * H + u];
    c[j][0] = c[j][1] = 0.f;
  }

  // zeroed buffers and x(0), x(1) in place in every CTA (and every CTA of
  // the cluster resident); then x(0) @ W_ih
  float ax[NT][4], ah[NT][4];
  cp_async_wait<K6_NX - 3>();
  cluster_arrive();
  cluster_wait();
  k6_product<NT>(ax, xring, LX, Din, wih, nt0, lane);
  cluster_arrive();

  for (int t = 0; t < T; ++t) {
    const int ti = d == 1 ? T - 1 - t : t;
    const bf16* hprev = hbuf + (t & 1) * K6_ROWS * LH;
    const int next = ((t + 1) & 1) * K6_ROWS * LH;
    cluster_wait();  // h_{t-1} and the x rows of step t + 1 in place everywhere
    if (kRegW)
      k6_product_regs<NT, KSR>(ah, hprev, LH, H, wr, lane);
    else
      k6_product<NT>(ah, hprev, LH, H, whh, nt0, lane);
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      const int u = 4 * (pair0 + warp * PPW + j) + q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows r0 and r0 + 8
        const int r = r0 + 8 * half;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int tile = 2 * j + (g >> 1), e = 2 * half + (g & 1);
          const float in = round_bf16(ax[tile][e] + bq[j][g]);
          gate[g] = round_bf16(in + round_bf16(ah[tile][e]));
        }
        const float ig = k6_sigmoid(gate[0]), fg = k6_sigmoid(gate[1]);
        const float gg = k6_tanh(gate[2]), og = k6_sigmoid(gate[3]);
        const float c32 = fg * c[j][half] + ig * gg;
        const bf16 h = __float2bfloat16(og * k6_tanh(c32));
        const bool valid = r < rows;
        c[j][half] = valid ? round_bf16(c32) : 0.f;
        const bf16 hv = valid ? h : __float2bfloat16(0.f);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < cl) hbufs[k][next + r * LH + u] = hv;
        if (valid) out[(((size_t)ti * D + d) * B + b0 + r) * H + u] = h;
      }
    }
    fetch_x(t + K6_NX - 1);
    cp_async_wait<K6_NX - 3>();  // this thread's x rows of step t + 2
    cluster_arrive();
    // x(t + 1) @ W_ih while the other CTAs and warps finish step t
    if (t + 1 < T) k6_product<NT>(ax, xring + ((t + 1) % K6_NX) * K6_ROWS * LX, LX, Din, wih, nt0, lane);
  }
  cluster_wait();  // no CTA leaves while another may still write into it
}

// Whether W_hh and W_ih of a CTA of a cl-CTA cluster sit in shared memory
// (W_hh first, unless it is held in registers), and the bytes it then
// takes.
struct K6Plan {
  bool whh_smem, wih_smem;
  size_t smem;
};

K6Plan k6_plan(int H, int Din, int cl, bool reg_whh) {
  K6Plan p;
  p.whh_smem = !reg_whh && k6_layout(H, Din, cl, true, false).total <= SMEM_LIMIT;
  p.wih_smem = k6_layout(H, Din, cl, p.whh_smem, true).total <= SMEM_LIMIT;
  p.smem = k6_layout(H, Din, cl, p.whh_smem, p.wih_smem).total;
  return p;
}

// The kernel for (H, cl): gate pairs per warp (2 up to H 128, 4 above),
// and W_hh in registers when a CTA has at most 256 threads at H <= 128.
struct K6Kernel {
  const void* fn;
  int threads;
  bool reg_whh;
};

K6Kernel k6_kernel(int H, int cl) {
  if (H > 128) return {(const void*)lstm_resident_kernel<4, false>, 32 * H / (16 * cl), false};
  const int threads = 32 * H / (8 * cl);
  if (threads <= 256) return {(const void*)lstm_resident_kernel<2, true>, threads, true};
  return {(const void*)lstm_resident_kernel<2, false>, threads, false};
}

// The launch of the kernel for (H, cl) over B rows and D directions.
cudaLaunchConfig_t k6_config(const K6Kernel& k, const K6Plan& plan, int cl, int B, int D,
                             cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * ((B + K6_ROWS - 1) / K6_ROWS), D);
  cfg.blockDim = dim3(k.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size of a call: the largest of 4, 2, 1 that splits the gate
// pairs evenly among whole warps and whose clusters all fit on the card at
// once (a cluster of 1 otherwise).  Probed once for each shape and device.
int resident_cluster(int H, int Din, int D, int B, int* cl_out) {
  static std::map<std::array<int, 5>, int> known;  // (device, H, Din, D, B) -> cluster size
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const std::array<int, 5> key{dev, H, Din, D, B};
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *cl_out = hit->second;
    return 0;
  }
  const int tiles = (B + K6_ROWS - 1) / K6_ROWS, P = H / 4, ppw = H > 128 ? 4 : 2;
  int chosen = 1;
  for (int cl = 4; cl > 1 && chosen == 1; cl /= 2) {
    if (P % (cl * ppw) != 0 || cl * tiles * D > sms) continue;
    const K6Kernel k = k6_kernel(H, cl);
    const K6Plan plan = k6_plan(H, Din, cl, k.reg_whh);
    err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = k6_config(k, plan, cl, B, D, nullptr, &attr);
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, k.fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit >= tiles * D) chosen = cl;
  }
  known[key] = chosen;
  *cl_out = chosen;
  return 0;
}

int launch_resident(const bf16* x, const uint2* wih_p, const uint2* whh_p, const float* bias,
                    bf16* out, int T, int D, int B, int Din, int H, cudaStream_t stream) {
  int cl;
  const int rc = resident_cluster(H, Din, D, B, &cl);
  if (rc != 0) return rc;
  const K6Kernel k = k6_kernel(H, cl);
  const K6Plan plan = k6_plan(H, Din, cl, k.reg_whh);
  cudaError_t err =
      cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k6_config(k, plan, cl, B, D, stream, &attr);
  int whh_smem = plan.whh_smem, wih_smem = plan.wih_smem;
  void* args[] = {&x, &wih_p, &whh_p, &bias, &out, &T, &D, &B, &Din, &H, &cl, &whh_smem, &wih_smem};
  err = cudaLaunchKernelExC(&cfg, k.fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches of one lstm_resident call (the wrappers count with this).
extern "C" int lstm_resident_launches() { return 1; }

// The cluster size lstm_resident takes for (B, D, Din, H) on the current
// device, or -1 on a CUDA error.
extern "C" int lstm_resident_cluster(int B, int D, int Din, int H) {
  int cl;
  return resident_cluster(H, Din, D, B, &cl) == 0 ? cl : -1;
}

// h [T, D, B, H] from x [B, T, Din] bf16, the packed w_ih and w_hh (uint2
// words [D, 4H/8, Din/16 or H/16, 32] of pack_gate_fragments) and bias
// [D, 4H] f32 in torch gate order, all contiguous device tensors; Din % 16
// == 0, H % 16 == 0, 16 <= H <= 256.  Direction 1 runs backward in time and
// writes its output time-aligned.  One launch on ``stream``.  Returns a
// cudaError_t.
extern "C" int lstm_resident(const void* x, const void* w_ih_packed, const void* w_hh_packed,
                             const void* bias, void* out, int T, int D, int B, int Din, int H,
                             void* stream_ptr) {
  const bf16* x_ = static_cast<const bf16*>(x);
  const uint2* wih = static_cast<const uint2*>(w_ih_packed);
  const uint2* whh = static_cast<const uint2*>(w_hh_packed);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return launch_resident(x_, wih, whh, b, o, T, D, B, Din, H, stream);
}
