// (Bi)LSTM recurrences for Hopper (sm_90a), torch gate order i, f, g, o:
//
//   lstm_recurrence (K5)  gates pre-projected: xw [T, D, B, 4H] ->
//                         h [T, D, B, H] (the backward direction comes
//                         pre-reversed in time and is written as it runs)
//   lstm_resident (K6)    the input projection inside: x [B, T, Din] ->
//                         h [T, D, B, H], both directions time-aligned
//
// They replace the TPU kernels ops/pallas/lstm.py::_kernel (through
// fused_bilstm) and ::_res_kernel (through resident_bilstm) of the JAX
// package, and round as those do:
//   K5  gates = f32(bf16(xw + bf16(h @ W_hh)))
//   K6  gates = f32(bf16(bf16(x @ W_ih + b) + bf16(h @ W_hh)))
// with f32 accumulation, sigmoid and tanh in f32 through __expf (a few ulp,
// far below the bf16 rounding that follows), c = bf16(f*c + i*g) and
// h = bf16(o * tanh(f*c + i*g)).  The state starts at zero; rows past B
// are neither kept in h nor stored.  One launch a call.
//
// What bounds them on this card.  Each of the T steps is a product of h
// [B, H] with W_hh [H, 4H], the gate math and a hand-over of h; nothing of
// step t + 1 but its gate inputs can be made ready before h_t exists.  So
// the time is T times the latency of one step, far above the bytes (a few
// MB) and the FLOPs (a few GFLOP) of a call at the dual-path shapes.
//
// K6, and K5 above 16 sequences: one step body (lstm_steps), differing
// only in where a step's gate inputs come from.
// - mma.sync m16n8k16 with 16 batch rows as M and the gate columns as N.
//   The wrappers pack W_hh (and K6's W_ih) in B-fragment order with the
//   gate columns interleaved (ops/kernels/lstm.py::pack_gate_fragments):
//   n-tile 2p holds (i, f) and n-tile 2p + 1 holds (g, o) of hidden units
//   4p .. 4p + 3, so a thread's accumulators hold all four gates of its own
//   cells (two rows, one unit, for each pair p of the warp).  The gate math
//   reads registers: no shared-memory round trip of the products.
// - A step is spread over a thread-block cluster of 1, 2 or 4 CTAs (as many
//   as fit on the card at once for the call's shape): each CTA owns 1/cl of
//   the gate pairs and its slice of the packed weights, and writes its part
//   of h_t into every CTA's h buffer through distributed shared memory.
//   Where a CTA has at most 256 threads (H <= 128), each warp holds its
//   W_hh fragments in registers; otherwise W_hh, and K6's W_ih, sit in
//   shared memory where they fit (W_hh first), else are read from L2.
// - One barrier a step, the cluster's, split in two: h is double-buffered,
//   and between arriving and waiting each CTA makes the next step's gate
//   inputs ready in registers: K6 computes x(t + 1) @ W_ih, K5 reads its
//   own gate columns of xw(t + 1), prefetched 3 steps ahead with cp.async
//   into a 4-slot ring.  No read of device memory stays on the critical path.
//
// K5 at 16 sequences or fewer (small_batch_steps; the wrapper's
// small_batch_body decides).  There the batch cannot fill the mma's 16 rows:
// the body above computed zeros in half of every product at B 8, read its
// W_hh slice (128 KB a CTA at H 256) from shared memory every step, and met
// every thread of the cluster at barrier.cluster once a step; it took 4.19
// us a step at BSRNN's band RNNs (T 751, D 2, B 8, H 256).  What paces a
// step there is the chain of dependent mma.sync on one warp (on an H100
// each link of an accumulator chain costs some 250 cycles, and a warp
// issues an m16n8k16 every ~30), then the gate math and the hand-over.  So:
// - The roles swap: gates^T [4H, B] = W_hh^T [4H, H] . h^T [H, B], the gate
//   rows as M, the batch as N (one n-tile of 8 up to B 8, two up to 16).
//   W_hh^T is packed as A fragments (pack_gate_rows) with the gate rows
//   interleaved: tile 0 of slice j holds i and f, tile 1 g and o, of hidden
//   units 8j .. 8j + 7, so a thread again holds all four gates of its cells.
// - Each slice belongs to a pair of warps that split K in halves and hold
//   their A fragments in registers (no weight byte read inside the loop);
//   each half runs up to 4 accumulators a tile (chains of 2 at H 256), hands
//   its partner the partial sums of the partner's cells through shared
//   memory (a 64-thread named barrier) and finishes the cells of its own
//   parity: the product's chain and the gate math a warp are both halved.
// - The H/8 slices are spread over a cluster of up to 8 CTAs (4 slices, 8
//   warps, a CTA: two warps on each scheduler), 16 SMs at the BSRNN shape.
// - h is handed over point to point: each warp sends its rows of h_t to
//   every CTA's double-buffered h in 16-byte st.async pieces, completed on
//   the receiver's mbarrier, which expects one step's bytes; a CTA waits on
//   its own mbarrier.  No barrier across the cluster inside the loop.
// - Each warp prefetches its own gate inputs 3 steps ahead with cp.async and
//   reads the next step's between handing over and waiting.
// It takes 0.90 us a step at (751, 2, 8, 256) on an H100 (0.68 ms a launch).
//
// The first port's K5 (one block per direction and 16 rows, WMMA products
// stored to shared memory as f32 and read back, two barriers and 8 cells of
// serial exact-expf gate math a thread a step, xw read from device memory
// on the critical path) took 11.1 us a step at the batch-1 column pass
// (T 242, D 2, B 100, H 128); K6 on this step took 2.86 us there.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 16;               // batch rows per cluster (the mma M)
constexpr int NX = 4;                  // slots of the input ring (prefetch 3 steps ahead)
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block can use

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Layout {
  size_t hbuf, ring, whh, wih, total;
};

// Shared memory in bytes of a CTA of a cl-CTA cluster: h [2][16][H + 8]
// bf16, the input ring [NX][16][XC + 8] bf16 (XC: K6's Din, or K5's 4H/cl
// gate columns), then the CTA's 1/cl of the packed W_hh and of K6's W_ih
// (Din = XC) where they fit.
__host__ __device__ inline Layout lstm_layout(int H, int XC, int cl, bool whh_smem, bool wih_smem) {
  Layout L;
  L.hbuf = 0;
  L.ring = L.hbuf + (size_t)2 * ROWS * (H + 8) * 2;
  L.whh = L.ring + (size_t)NX * ROWS * (XC + 8) * 2;
  L.whh = (L.whh + 127) / 128 * 128;
  L.wih = L.whh + (whh_smem ? (size_t)H * 4 * H * 2 / cl : 0);
  L.total = L.wih + (wih_smem ? (size_t)XC * 4 * H * 2 / cl : 0);
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
__device__ __forceinline__ void product(float (&acc)[NT][4], const bf16* A, int lda, int K,
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
__device__ __forceinline__ void product_regs(float (&acc)[NT][4], const bf16* A, int lda, int K,
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

__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float fast_tanh(float x) { return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x)); }

// The step body of both kernels.  One cluster of cl thread blocks per (16
// batch rows, direction); CTA k of the cluster owns gate pairs k*P/cl ..
// (k+1)*P/cl - 1 (P = H/4; 16 columns and 4 hidden units a pair) with
// 32 * P / (cl * PPW) threads, warp w pairs w*PPW .. w*PPW + PPW - 1 of
// those.  Each CTA writes its part of h_t into every CTA's h buffer
// (distributed shared memory), then arrives at the cluster barrier, makes
// the next step's gate inputs ready, and waits.
// kRegW: the warp's W_hh fragments live in registers (H <= 128, at most
// 256 threads a CTA).  kPre: the gate inputs are K5's pre-projected xw
// [T, D, B, 4H] (``in``; direction 1 pre-reversed, h stored as it runs);
// otherwise K6's x [B, T, Din] with W_ih and the bias (direction 1 runs
// backward in time, h stored time-aligned).
template <int PPW, bool kRegW, bool kPre>
__device__ __forceinline__ void lstm_steps(unsigned char* smem, const bf16* __restrict__ in,
                                           const uint2* __restrict__ wih_p,
                                           const uint2* __restrict__ whh_p,
                                           const float* __restrict__ bias, bf16* __restrict__ out,
                                           int T, int D, int B, int Din, int H, int cl, int whh_smem,
                                           int wih_smem) {
  constexpr int NT = 2 * PPW;          // n-tiles a warp owns
  constexpr int KSR = kRegW ? 8 : 1;   // k-steps of W_hh held in registers
  const int G = 4 * H, HC = H / cl, XC = kPre ? 4 * HC : Din;
  const Layout L = lstm_layout(H, XC, cl, whh_smem, wih_smem);
  const int LH = H + 8, LX = XC + 8;
  bf16* hbuf = reinterpret_cast<bf16*>(smem + L.hbuf);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  const int rank = cl > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const int d = blockIdx.y, b0 = (blockIdx.x / cl) * ROWS;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int pair0 = rank * (H / 4 / cl);  // first gate pair of this CTA
  const int nt0 = warp * NT;              // first n-tile of this warp, within the CTA's

  // this CTA's n-tiles of the packed weights of direction d: in registers,
  // or in shared memory where they fit, or read from L2
  const size_t whh_words = (size_t)H * G / 4 / cl;
  const uint2* whh = whh_p + (d * cl + rank) * whh_words;
  const uint2* wih = nullptr;
  if (!kPre) wih = wih_p + (d * cl + rank) * ((size_t)Din * G / 4 / cl);
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
  if (!kPre && wih_smem) {
    const size_t wih_words = (size_t)Din * G / 4 / cl;
    uint4* dst = reinterpret_cast<uint4*>(smem + L.wih);
    const uint4* src = reinterpret_cast<const uint4*>(wih);
    for (size_t i = tid; i < wih_words / 2; i += nthr) dst[i] = src[i];
    wih = reinterpret_cast<const uint2*>(smem + L.wih);
  }
  // h_{-1} = 0, and zero ring rows past B in every slot (rows < B are only
  // ever written by cp.async, so nothing races with these stores)
  const int rows = min(ROWS, B - b0);
  for (int i = tid; i < 2 * ROWS * LH; i += nthr) hbuf[i] = __float2bfloat16(0.f);
  for (int i = tid; i < NX * (ROWS - rows) * LX; i += nthr) {
    const int slot = i / ((ROWS - rows) * LX), rest = i - slot * (ROWS - rows) * LX;
    ring[(slot * ROWS + rows) * LX + rest] = __float2bfloat16(0.f);
  }
  // every CTA's h buffer, this CTA's first
  bf16* hbufs[4] = {hbuf, hbuf, hbuf, hbuf};
  if (cl > 1) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    for (int k = 1; k < cl; ++k) hbufs[k] = cluster.map_shared_rank(hbuf, (rank + k) % cl);
  }

  auto fetch = [&](int s) {  // the gate inputs of step s into slot s % NX
    if (s < T) {
      bf16* slot = ring + (s % NX) * ROWS * LX;
      if (kPre) {
        // xw[s, d, b0 + r, g*H + 4*pair0 ..]: HC/8 16-byte chunks a gate
        const bf16* src = in + (((size_t)s * D + d) * B + b0) * G + 4 * pair0;
        const int cpg = HC / 8, cpr = 4 * cpg;
        for (int i = tid; i < rows * cpr; i += nthr) {
          const int r = i / cpr, rest = i - r * cpr, g = rest / cpg, c = (rest - g * cpg) * 8;
          cp_async16(slot + r * LX + g * HC + c, src + (size_t)r * G + g * H + c);
        }
      } else {
        const int ti = d == 1 ? T - 1 - s : s, vpr = Din / 8;
        for (int i = tid; i < rows * vpr; i += nthr) {
          const int r = i / vpr, c = (i - r * vpr) * 8;
          cp_async16(slot + r * LX + c, in + ((size_t)(b0 + r) * T + ti) * Din + c);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NX - 1; ++s) fetch(s);

  // this thread's cells: unit 4 (pair0 + warp*PPW + j) + lane % 4 for each
  // pair j of the warp, rows r0 and r0 + 8
  const int r0 = lane >> 2, q = lane & 3;
  float bq[PPW][4], c[PPW][2];
#pragma unroll
  for (int j = 0; j < PPW; ++j) {
    const int u = 4 * (pair0 + warp * PPW + j) + q;
#pragma unroll
    for (int g = 0; g < 4; ++g) bq[j][g] = kPre ? 0.f : bias[(size_t)d * G + g * H + u];
    c[j][0] = c[j][1] = 0.f;
  }

  // the gate inputs of step s, laid out as the accumulators: K6 x(s) @
  // W_ih (the bias is added in the gate math), K5 this thread's cells'
  // columns of xw(s)
  auto inputs = [&](float (&ax)[NT][4], int s) {
    const bf16* slot = ring + (s % NX) * ROWS * LX;
    if (kPre) {
#pragma unroll
      for (int j = 0; j < PPW; ++j) {
        const int ul = 4 * (warp * PPW + j) + q;  // unit within the CTA's
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            ax[2 * j + (g >> 1)][2 * half + (g & 1)] =
                __bfloat162float(slot[(r0 + 8 * half) * LX + g * HC + ul]);
      }
    } else {
      product<NT>(ax, slot, LX, Din, wih, nt0, lane);
    }
  };

  // zeroed buffers and the inputs of steps 0 and 1 in place in every CTA
  // (and every CTA of the cluster resident); then step 0's gate inputs
  float ax[NT][4], ah[NT][4];
  cp_async_wait<NX - 3>();
  cluster_arrive();
  cluster_wait();
  inputs(ax, 0);
  cluster_arrive();

  for (int t = 0; t < T; ++t) {
    const int ti = (kPre || d == 0) ? t : T - 1 - t;
    const bf16* hprev = hbuf + (t & 1) * ROWS * LH;
    const int next = ((t + 1) & 1) * ROWS * LH;
    cluster_wait();  // h_{t-1} and the inputs of step t + 1 in place everywhere
    if (kRegW)
      product_regs<NT, KSR>(ah, hprev, LH, H, wr, lane);
    else
      product<NT>(ah, hprev, LH, H, whh, nt0, lane);
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
          const float xin = kPre ? ax[tile][e] : round_bf16(ax[tile][e] + bq[j][g]);
          gate[g] = round_bf16(xin + round_bf16(ah[tile][e]));
        }
        const float ig = fast_sigmoid(gate[0]), fg = fast_sigmoid(gate[1]);
        const float gg = fast_tanh(gate[2]), og = fast_sigmoid(gate[3]);
        const float c32 = fg * c[j][half] + ig * gg;
        const bf16 h = __float2bfloat16(og * fast_tanh(c32));
        const bool valid = r < rows;
        c[j][half] = valid ? round_bf16(c32) : 0.f;
        const bf16 hv = valid ? h : __float2bfloat16(0.f);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < cl) hbufs[k][next + r * LH + u] = hv;
        if (valid) out[(((size_t)ti * D + d) * B + b0 + r) * H + u] = h;
      }
    }
    fetch(t + NX - 1);
    cp_async_wait<NX - 3>();  // this thread's inputs of step t + 2
    cluster_arrive();
    // step t + 1's gate inputs while the other CTAs and warps finish step t
    if (t + 1 < T) inputs(ax, t + 1);
  }
  cluster_wait();  // no CTA leaves while another may still write into it
}

// ---- K5's few-sequence body (B <= 16) ----

constexpr int XROW = 40;  // bf16 a batch row of a warp's input slot: 4 gates x 8 units, 8 of padding

// Shared memory of a CTA of the few-sequence body with wpc warps (two a
// slice) and up to kw k-steps a warp: two mbarriers; h [2][4 kw][NB][8][8]
// bf16 (slice j: hidden units 8j .. 8j + 7, batch-major; slices past H/8
// stay zero); each warp's partial gate sums for its partner [wpc][32][4 NB]
// f32; each warp's input ring [NX][4 NB][XROW] bf16 (its batch rows) and
// its staging rows [4 NB][8] bf16.
struct SmallLayout {
  size_t hbuf, part, ring, stage, total;
};

__host__ __device__ inline SmallLayout small_layout(int nb, int wpc, int kw) {
  SmallLayout L;
  L.hbuf = 128;  // the mbarriers first
  L.part = L.hbuf + (size_t)2 * 4 * kw * nb * 128;
  L.ring = L.part + (size_t)wpc * 32 * 4 * nb * 4;
  L.stage = L.ring + (size_t)wpc * NX * 4 * nb * XROW * 2;
  L.total = L.stage + (size_t)wpc * 4 * nb * 16;
  return L;
}

__device__ __forceinline__ void mma_bf16_a(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 16 bytes from global memory, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of ``addr`` (a shared::cta address) in CTA ``rank``
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another CTA's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async16(uint32_t addr, const uint4& v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
               ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
               : "memory");
}

// The two warps of a slice meet (named barrier 1 + pair, 64 threads)
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// K5's step body at B <= 16: gates^T [4H, B] = W_hh^T [4H, H] . h^T [H, B]
// with the gate rows as the mma's M and the batch as its N (NB n-tiles of
// 8).  A slice of 8 hidden units (32 gate rows, two m16 tiles: rows g and
// g + 8 of tile 0 are i and f of unit 8j + g, of tile 1 g and o) belongs to
// a pair of warps, each holding W_hh^T's A fragments of those rows over one
// half of K (up to KW k-steps) in registers, its products in S independent
// accumulators a tile.  Each warp hands its partner the partial sums of the
// partner's cells through shared memory, and finishes the cells of its own
// parity: thread (g, q) of warp half e owns unit 8j + g at batches
// 8 nt + 2q + e, whose i, f, g and o it holds in registers.  The H/8 slices
// are split among the cl CTAs of the direction's cluster; after the gate
// math a warp sends its rows of h_t to every CTA's h buffer in 16-byte
// st.async pieces counted on that CTA's mbarrier, and a CTA waits on its
// own mbarrier for the bytes of step t - 1: no barrier across the cluster
// within the loop.  Each warp prefetches its own gate inputs 3 steps ahead
// with cp.async (a 16-byte piece a lane) and reads the next step's into
// registers between handing over and waiting.
template <int NB, int KW>
__device__ __forceinline__ void small_batch_steps(unsigned char* smem, const bf16* __restrict__ xw,
                                                  const uint4* __restrict__ whh_p,
                                                  bf16* __restrict__ out, int T, int D, int B, int H,
                                                  int cl) {
  constexpr int S = KW < 4 ? KW : 4;  // accumulators a tile and n-tile
  constexpr int ROWS_W = 4 * NB;      // batch rows a warp finishes (one parity)
  constexpr int HS = 4 * KW;          // slices of an h buffer, the zero ones past H/8 included
  const int J = H / 8, ks_n = H / 16, wpc = blockDim.x / 32;
  const SmallLayout L = small_layout(NB, wpc, KW);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t bars = base;  // two mbarriers, one for each h buffer
  bf16* hbuf = reinterpret_cast<bf16*>(smem + L.hbuf);
  const int rank = cl > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  const int d = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this CTA's slices: an even split of the J slices among the cl CTAs
  const int j0 = rank * J / cl, nslices = (rank + 1) * J / cl - j0;
  const int pair = warp >> 1, half = warp & 1;
  const bool active = pair < nslices;
  const int j = j0 + pair;
  const int kh = (ks_n + 1) / 2, ks0 = half ? kh : 0, nks = half ? ks_n - kh : kh;  // this warp's k-steps
  const uint32_t h_bytes = (uint32_t)J * NB * 128;  // one step's h, every slice

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * HS * NB * 64; i += blockDim.x) hbuf[i] = __float2bfloat16(0.f);  // h_{-1}, pads
  __syncthreads();
  if (tid == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bars) : "memory");  // buffer 0 ready
    mbar_arrive_expect_tx(bars + 8, h_bytes);                                             // h_0 into buffer 1
  }
  cluster_arrive();  // every CTA's barriers initialised before any piece is sent
  cluster_wait();

  if (active) {
    bf16* ring = reinterpret_cast<bf16*>(smem + L.ring) + (size_t)warp * NX * ROWS_W * XROW;
    bf16* stage = reinterpret_cast<bf16*>(smem + L.stage) + warp * ROWS_W * 8;
    float* part_out = reinterpret_cast<float*>(smem + L.part) + (size_t)(warp * 32 + lane) * 4 * NB;
    const float* part_in = reinterpret_cast<const float*>(smem + L.part) + (size_t)((warp ^ 1) * 32 + lane) * 4 * NB;
    const int g = lane >> 2, q = lane & 3;

    uint4 wr[2][KW];  // A fragments of this warp's two tiles of W_hh^T over its k-steps
    const uint4* wsrc = whh_p + ((size_t)(d * J + j) * 2 * ks_n + ks0) * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < KW; ++ks)
        wr[mt][ks] = ks < nks ? wsrc[((size_t)mt * ks_n + ks) * 32] : make_uint4(0u, 0u, 0u, 0u);

    // the gate inputs of step s: xw[s, d, b, gate*H + 8j ..] of this warp's
    // rows b = 8 nt + 2 r + half (local row 4 nt + r), one piece a lane
    auto fetch = [&](int s) {
      if (s < T && lane < ROWS_W * 4) {
        bf16* slot = ring + (s % NX) * ROWS_W * XROW;
        const int rl = lane >> 2, gate = lane & 3, b = (rl >> 2) * 8 + 2 * (rl & 3) + half;
        const bf16* src = xw + (((size_t)s * D + d) * B + (b < B ? b : 0)) * 4 * H + gate * H + 8 * j;
        cp_async16_zfill(slot + rl * XROW + gate * 8, src, b < B ? 16 : 0);
      }
      cp_async_commit();
    };
    auto inputs = [&](float (&ax)[NB][4], int s) {
      const bf16* slot = ring + (s % NX) * ROWS_W * XROW;
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          ax[nt][gate] = __bfloat162float(slot[(nt * 4 + q) * XROW + gate * 8 + g]);
    };

#pragma unroll
    for (int s = 0; s < NX - 1; ++s) fetch(s);
    float c[NB], ax[NB][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) c[nt] = 0.f;
    cp_async_wait<NX - 2>();
    __syncwarp();
    inputs(ax, 0);

    for (int t = 0; t < T; ++t) {
      const int cur = t & 1, nxt = cur ^ 1;
      mbar_wait(bars + 8 * cur, (t >> 1) & 1);  // h_{t-1} in buffer cur, every slice
      if (tid == 0) mbar_arrive_expect_tx(bars + 8 * cur, h_bytes);  // its next use: h_{t+1}
      const bf16* hprev = hbuf + (size_t)cur * HS * NB * 64;

      // B fragments of this warp's k-steps: slices 2 (ks0 + ks) and + 1, rows of n-tile nt
      uint32_t bf[NB][KW][2];
#pragma unroll
      for (int ks = 0; ks < KW; ks += 2)
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          uint32_t b4[4];
          ldmatrix_x4(b4, hprev + (((2 * (ks0 + ks) + (lane >> 3)) * NB + nt) * 8 + (lane & 7)) * 8);
          bf[nt][ks][0] = b4[0];
          bf[nt][ks][1] = b4[1];
          bf[nt][ks + 1][0] = b4[2];
          bf[nt][ks + 1][1] = b4[3];
        }
      float acc[2][NB][S][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int sp = 0; sp < S; ++sp) acc[mt][nt][sp][0] = acc[mt][nt][sp][1] = acc[mt][nt][sp][2] = acc[mt][nt][sp][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KW; ++ks)
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16_a(acc[mt][nt][ks % S], wr[mt][ks], bf[nt][ks][0], bf[nt][ks][1]);

      // this half of K's sums: element 2 (gate & 1) + e of tile gate >> 1 is
      // gate (i, f, g, o) of the cell at batch 8 nt + 2q + e
      float own[NB][4], give[NB][4];
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = acc[gate >> 1][nt][0][2 * (gate & 1) + e];
#pragma unroll
            for (int sp = 1; sp < S; ++sp) v += acc[gate >> 1][nt][sp][2 * (gate & 1) + e];
            if (e == half) own[nt][gate] = v; else give[nt][gate] = v;
          }
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
        *reinterpret_cast<float4*>(part_out + 4 * nt) = make_float4(give[nt][0], give[nt][1], give[nt][2], give[nt][3]);
      pair_sync(pair);
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const float4 other = *reinterpret_cast<const float4*>(part_in + 4 * nt);
        const float sum[4] = {own[nt][0] + other.x, own[nt][1] + other.y, own[nt][2] + other.z, own[nt][3] + other.w};
        float gate[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) gate[gi] = round_bf16(ax[nt][gi] + round_bf16(sum[gi]));
        const float ig = fast_sigmoid(gate[0]), fg = fast_sigmoid(gate[1]);
        const float gg = fast_tanh(gate[2]), og = fast_sigmoid(gate[3]);
        const float c32 = fg * c[nt] + ig * gg;
        const bf16 h = __float2bfloat16(og * fast_tanh(c32));
        const bool valid = nt * 8 + 2 * q + half < B;
        c[nt] = valid ? round_bf16(c32) : 0.f;
        stage[(nt * 4 + q) * 8 + g] = valid ? h : __float2bfloat16(0.f);
      }
      __syncwarp();
      const int p = lane % ROWS_W;                       // a local row: batch row b of the slice
      const int b = (p >> 2) * 8 + 2 * (p & 3) + half;
      const uint4 piece = reinterpret_cast<const uint4*>(stage)[p];
      if (t + 1 < T) {  // h_t to every CTA of the cluster, this one included
        const uint32_t off = base + (uint32_t)(L.hbuf + (((size_t)nxt * HS + j) * NB * 8 + b) * 16);
        for (int k = lane / ROWS_W; k < cl; k += 32 / ROWS_W)
          st_async16(map_rank(off, k), piece, map_rank(bars + 8 * nxt, k));
      }
      if (lane < ROWS_W && b < B)
        *reinterpret_cast<uint4*>(out + (((size_t)t * D + d) * B + b) * H + 8 * j) = piece;
      fetch(t + NX - 1);
      cp_async_wait<NX - 2>();  // this lane's piece of step t + 1
      __syncwarp();
      if (t + 1 < T) inputs(ax, t + 1);
    }
  }
  cluster_arrive();  // no CTA leaves while another may still send to it
  cluster_wait();
}

// K5.  NB 0: the step body shared with K6 (lstm_steps), W_hh packed by
// pack_gate_fragments; NB 1 or 2: the few-sequence body for B <= 8 NB with
// up to KW k-steps a warp (small_batch_steps), W_hh packed by
// pack_gate_rows.
template <int PPW, bool kRegW, int NB = 0, int KW = 0>
__global__ void __launch_bounds__(NB > 0 || kRegW ? 256 : 512)
lstm_recurrence_kernel(const bf16* __restrict__ xw, const uint2* __restrict__ whh_p,
                       bf16* __restrict__ out, int T, int D, int B, int H, int cl, int whh_smem) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (NB > 0)
    small_batch_steps<NB, KW>(smem, xw, reinterpret_cast<const uint4*>(whh_p), out, T, D, B, H, cl);
  else
    lstm_steps<PPW, kRegW, true>(smem, xw, nullptr, whh_p, nullptr, out, T, D, B, 0, H, cl, whh_smem, 0);
}

template <int PPW, bool kRegW>
__global__ void __launch_bounds__(kRegW ? 256 : 512)
lstm_resident_kernel(const bf16* __restrict__ x, const uint2* __restrict__ wih_p,
                     const uint2* __restrict__ whh_p, const float* __restrict__ bias,
                     bf16* __restrict__ out, int T, int D, int B, int Din, int H, int cl,
                     int whh_smem, int wih_smem) {
  extern __shared__ __align__(128) unsigned char smem[];
  lstm_steps<PPW, kRegW, false>(smem, x, wih_p, whh_p, bias, out, T, D, B, Din, H, cl, whh_smem,
                                wih_smem);
}

// Whether W_hh and K6's W_ih of a CTA of a cl-CTA cluster sit in shared
// memory (W_hh first, unless it is held in registers), and the bytes it
// then takes; XC is the input ring's row width.
struct Plan {
  bool whh_smem, wih_smem;
  size_t smem;
};

Plan lstm_plan(int H, int XC, int cl, bool reg_whh, bool has_wih) {
  Plan p;
  p.whh_smem = !reg_whh && lstm_layout(H, XC, cl, true, false).total <= SMEM_LIMIT;
  p.wih_smem = has_wih && lstm_layout(H, XC, cl, p.whh_smem, true).total <= SMEM_LIMIT;
  p.smem = lstm_layout(H, XC, cl, p.whh_smem, p.wih_smem).total;
  return p;
}

// The input ring's row width: K5's 4H/cl gate columns, K6's Din.
int ring_cols(int H, int Din, int cl, bool pre) { return pre ? 4 * H / cl : Din; }

// The kernel for (H, cl) of K5 (pre) or K6: gate pairs per warp (2 up to
// H 128, 4 above), and W_hh in registers when a CTA has at most 256
// threads at H <= 128.
struct Kernel {
  const void* fn;
  int threads;
  bool reg_whh;
};

Kernel pick_kernel(int H, int cl, bool pre) {
  if (H > 128)
    return {pre ? (const void*)lstm_recurrence_kernel<4, false, 0> : (const void*)lstm_resident_kernel<4, false>,
            32 * H / (16 * cl), false};
  const int threads = 32 * H / (8 * cl);
  if (threads <= 256)
    return {pre ? (const void*)lstm_recurrence_kernel<2, true, 0> : (const void*)lstm_resident_kernel<2, true>,
            threads, true};
  return {pre ? (const void*)lstm_recurrence_kernel<2, false, 0> : (const void*)lstm_resident_kernel<2, false>,
          threads, false};
}

// K5's few-sequence kernel for B rows and cl CTAs a direction: one n-tile
// of 8 rows up to B 8, two up to 16; a pair of warps a slice of 8 hidden
// units, the H/8 slices split evenly among the CTAs, each warp up to KW of
// the H/16 k-steps (half of them, rounded up to 2, 4 or 8).
int small_kw(int H) {
  const int half = (H / 16 + 1) / 2;
  return half <= 2 ? 2 : half <= 4 ? 4 : 8;
}

Kernel pick_small_kernel(int H, int B, int cl) {
  static const void* const fns[2][3] = {
      {(const void*)lstm_recurrence_kernel<0, true, 1, 2>, (const void*)lstm_recurrence_kernel<0, true, 1, 4>,
       (const void*)lstm_recurrence_kernel<0, true, 1, 8>},
      {(const void*)lstm_recurrence_kernel<0, true, 2, 2>, (const void*)lstm_recurrence_kernel<0, true, 2, 4>,
       (const void*)lstm_recurrence_kernel<0, true, 2, 8>}};
  const int kw = small_kw(H);
  return {fns[B <= 8 ? 0 : 1][kw == 2 ? 0 : kw == 4 ? 1 : 2], 2 * 32 * ((H / 8 + cl - 1) / cl), true};
}

size_t small_smem(int H, int B, int cl) {
  return small_layout(B <= 8 ? 1 : 2, 2 * ((H / 8 + cl - 1) / cl), small_kw(H)).total;
}

// The launch of a kernel with cl-CTA clusters: grid (cl * groups, D).
cudaLaunchConfig_t launch_config(const Kernel& k, size_t smem, int cl, int groups, int D,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * groups, D);
  cfg.blockDim = dim3(k.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many of the plan's clusters fit on the card at once (0 if none).
int clusters_that_fit(const Kernel& k, size_t smem, int cl, int groups, int D, int* fit) {
  cudaError_t err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(k, smem, cl, groups, D, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(fit, k.fn, &cfg);
}

// The cluster size of a call.  The step body shared with K6: the largest of
// 4, 2, 1 that splits the gate pairs evenly among whole warps and whose
// clusters all fit on the card at once (a cluster of 1 otherwise).  K5's
// few-sequence body: the smallest of 1, 2, 4, 8 that gives each CTA at most
// 4 slices (8 warps, two on each scheduler of the SM), if its D clusters
// fit at once.  Probed once for each shape, body and device.
int choose_cluster(int H, int Din, int D, int B, bool pre, bool small, int* cl_out) {
  static std::map<std::array<int, 7>, int> known;  // (device, H, Din, D, B, pre, small) -> cluster size
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const std::array<int, 7> key{dev, H, Din, D, B, pre ? 1 : 0, small ? 1 : 0};
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *cl_out = hit->second;
    return 0;
  }
  int chosen = 0;
  if (small) {
    int cl = 1;
    while ((H / 8 + cl - 1) / cl > 4) cl *= 2;
    int fit = 0;
    const int rc = clusters_that_fit(pick_small_kernel(H, B, cl), small_smem(H, B, cl), cl, 1, D, &fit);
    if (rc != 0) return rc;
    if (fit < D || cl * D > sms) return (int)cudaErrorInvalidConfiguration;
    chosen = cl;
  } else {
    const int tiles = (B + ROWS - 1) / ROWS, P = H / 4, ppw = H > 128 ? 4 : 2;
    chosen = 1;
    for (int cl = 4; cl > 1 && chosen == 1; cl /= 2) {
      if (P % (cl * ppw) != 0 || cl * tiles * D > sms) continue;
      const Kernel k = pick_kernel(H, cl, pre);
      const Plan plan = lstm_plan(H, ring_cols(H, Din, cl, pre), cl, k.reg_whh, !pre);
      int fit = 0;
      const int rc = clusters_that_fit(k, plan.smem, cl, tiles, D, &fit);
      if (rc != 0) return rc;
      if (fit >= tiles * D) chosen = cl;
    }
  }
  known[key] = chosen;
  *cl_out = chosen;
  return 0;
}

// One launch of K5 (pre: in = xw, no W_ih or bias; small: the few-sequence
// body) or K6 (in = x).
int launch(bool pre, bool small, const bf16* in, const uint2* wih_p, const uint2* whh_p, const float* bias,
           bf16* out, int T, int D, int B, int Din, int H, cudaStream_t stream) {
  int cl;
  const int rc = choose_cluster(H, Din, D, B, pre, small, &cl);
  if (rc != 0) return rc;
  Kernel k;
  size_t smem;
  int groups, whh_smem = 0, wih_smem = 0;
  if (small) {
    k = pick_small_kernel(H, B, cl);
    smem = small_smem(H, B, cl);
    groups = 1;
  } else {
    k = pick_kernel(H, cl, pre);
    const Plan plan = lstm_plan(H, ring_cols(H, Din, cl, pre), cl, k.reg_whh, !pre);
    smem = plan.smem;
    groups = (B + ROWS - 1) / ROWS;
    whh_smem = plan.whh_smem;
    wih_smem = plan.wih_smem;
  }
  cudaError_t err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(k, smem, cl, groups, D, stream, &attr);
  if (pre) {
    void* args[] = {&in, &whh_p, &out, &T, &D, &B, &H, &cl, &whh_smem};
    err = cudaLaunchKernelExC(&cfg, k.fn, args);
  } else {
    void* args[] = {&in, &wih_p, &whh_p, &bias, &out, &T, &D, &B, &Din, &H, &cl, &whh_smem, &wih_smem};
    err = cudaLaunchKernelExC(&cfg, k.fn, args);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// h [T, D, B, H] from pre-projected gates xw [T, D, B, 4H] bf16 and the
// packed w_hh, all contiguous device tensors, xw 16-byte aligned;
// H % 16 == 0, 16 <= H <= 256.  small (B <= 16; the wrapper's
// small_batch_body decides): the few-sequence body, w_hh as uint4 words
// [D, H/8, 2, H/16, 32] of pack_gate_rows; otherwise the step body shared
// with K6, w_hh as uint2 words [D, 4H/8, H/16, 32] of pack_gate_fragments.
// One launch on ``stream``.  Returns a cudaError_t.
extern "C" int lstm_recurrence(const void* xw, const void* w_hh_packed, void* out, int T, int D,
                               int B, int H, int small, void* stream_ptr) {
  if (small && B > 16) return (int)cudaErrorInvalidValue;
  return launch(true, small != 0, static_cast<const bf16*>(xw), nullptr,
                static_cast<const uint2*>(w_hh_packed), nullptr, static_cast<bf16*>(out), T, D, B, 0, H,
                static_cast<cudaStream_t>(stream_ptr));
}

// The cluster size lstm_recurrence takes for (B, D, H) and the body
// ``small`` on the current device, or -1 on a CUDA error.
extern "C" int lstm_recurrence_cluster(int B, int D, int H, int small) {
  int cl;
  return choose_cluster(H, 0, D, B, true, small != 0, &cl) == 0 ? cl : -1;
}

// Launches of one lstm_resident call (the wrappers count with this).
extern "C" int lstm_resident_launches() { return 1; }

// The cluster size lstm_resident takes for (B, D, Din, H) on the current
// device, or -1 on a CUDA error.
extern "C" int lstm_resident_cluster(int B, int D, int Din, int H) {
  int cl;
  return choose_cluster(H, Din, D, B, false, false, &cl) == 0 ? cl : -1;
}

// h [T, D, B, H] from x [B, T, Din] bf16, the packed w_ih and w_hh (uint2
// words [D, 4H/8, Din/16 or H/16, 32] of pack_gate_fragments) and bias
// [D, 4H] f32 in torch gate order, all contiguous device tensors, x
// 16-byte aligned; Din % 16 == 0, H % 16 == 0, 16 <= H <= 256.  Direction
// 1 runs backward in time and writes its output time-aligned.  One launch
// on ``stream``.  Returns a cudaError_t.
extern "C" int lstm_resident(const void* x, const void* w_ih_packed, const void* w_hh_packed,
                             const void* bias, void* out, int T, int D, int B, int Din, int H,
                             void* stream_ptr) {
  return launch(false, false, static_cast<const bf16*>(x), static_cast<const uint2*>(w_ih_packed),
                static_cast<const uint2*>(w_hh_packed), static_cast<const float*>(bias),
                static_cast<bf16*>(out), T, D, B, Din, H, static_cast<cudaStream_t>(stream_ptr));
}
