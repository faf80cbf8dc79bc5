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
// What bounds them on this card.  Each of the T steps is a [16, H] x
// [H, 4H] product per 16 batch rows, the gate math and a hand-over of h;
// nothing of step t + 1 but its gate inputs can be made ready before h_t
// exists.  So the time is T times the latency of one step, far above the
// bytes (a few MB) and the FLOPs (a few GFLOP) of a call at the dual-path
// shapes.
//
// What the design does about it.  Both kernels run one step body
// (lstm_steps) and differ only in where a step's gate inputs come from.
// - mma.sync m16n8k16 with its documented fragment layout.  The wrappers
//   pack W_hh (and K6's W_ih) in fragment order with the gate columns
//   interleaved (ops/kernels/lstm.py::pack_gate_fragments): n-tile 2p holds
//   (i, f) and n-tile 2p + 1 holds (g, o) of hidden units 4p .. 4p + 3, so a
//   thread's accumulators hold all four gates of its own cells (two rows,
//   one unit, for each pair p of the warp).  The gate math reads registers:
//   no shared-memory round trip of the products.  A lane's B fragment is
//   one 8-byte word, and a warp's 32 words are contiguous.
// - A step is spread over a thread-block cluster of 1, 2 or 4 CTAs (as many
//   as fit on the card at once for the call's shape): each CTA owns 1/cl of
//   the gate pairs and its slice of the packed weights, and writes its part
//   of h_t into every CTA's h buffer through distributed shared memory.
//   Where a CTA has at most 256 threads (H <= 128), each warp holds its
//   W_hh fragments in registers; otherwise W_hh, and K6's W_ih, sit in
//   shared memory where they fit (W_hh first), else are read from L2 in the
//   same order.
// - One barrier a step, the cluster's, split in two: h is double-buffered,
//   and between arriving and waiting each CTA makes the next step's gate
//   inputs ready in registers, which needs nothing of h_t: K6 computes
//   x(t + 1) @ W_ih, K5 reads its own gate columns of xw(t + 1).  Those
//   inputs are prefetched 3 steps ahead with cp.async into a 4-slot ring:
//   K6's x rows, or K5's four runs of H/cl gate columns of the CTA's 16
//   rows, one run a gate (the CTA's hidden units are contiguous, so its
//   columns of each gate are too).  No read of device memory stays on a
//   step's critical path.  K6's bias sits in registers.
// - 2 gate pairs (8 columns of each of the four gates) per warp up to H
//   128, 4 pairs per warp above.
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

template <int PPW, bool kRegW>
__global__ void __launch_bounds__(kRegW ? 256 : 512)
lstm_recurrence_kernel(const bf16* __restrict__ xw, const uint2* __restrict__ whh_p,
                       bf16* __restrict__ out, int T, int D, int B, int H, int cl, int whh_smem) {
  extern __shared__ __align__(128) unsigned char smem[];
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
    return {pre ? (const void*)lstm_recurrence_kernel<4, false> : (const void*)lstm_resident_kernel<4, false>,
            32 * H / (16 * cl), false};
  const int threads = 32 * H / (8 * cl);
  if (threads <= 256)
    return {pre ? (const void*)lstm_recurrence_kernel<2, true> : (const void*)lstm_resident_kernel<2, true>,
            threads, true};
  return {pre ? (const void*)lstm_recurrence_kernel<2, false> : (const void*)lstm_resident_kernel<2, false>,
          threads, false};
}

// The launch of a kernel for (H, cl) over B rows and D directions.
cudaLaunchConfig_t launch_config(const Kernel& k, const Plan& plan, int cl, int B, int D,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * ((B + ROWS - 1) / ROWS), D);
  cfg.blockDim = dim3(k.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size of a call: the largest of 4, 2, 1 that splits the gate
// pairs evenly among whole warps and whose clusters all fit on the card at
// once (a cluster of 1 otherwise).  Probed once for each shape, kernel and
// device.
int choose_cluster(int H, int Din, int D, int B, bool pre, int* cl_out) {
  static std::map<std::array<int, 6>, int> known;  // (device, H, Din, D, B, pre) -> cluster size
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const std::array<int, 6> key{dev, H, Din, D, B, pre ? 1 : 0};
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *cl_out = hit->second;
    return 0;
  }
  const int tiles = (B + ROWS - 1) / ROWS, P = H / 4, ppw = H > 128 ? 4 : 2;
  int chosen = 1;
  for (int cl = 4; cl > 1 && chosen == 1; cl /= 2) {
    if (P % (cl * ppw) != 0 || cl * tiles * D > sms) continue;
    const Kernel k = pick_kernel(H, cl, pre);
    const Plan plan = lstm_plan(H, ring_cols(H, Din, cl, pre), cl, k.reg_whh, !pre);
    err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(k, plan, cl, B, D, nullptr, &attr);
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, k.fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit >= tiles * D) chosen = cl;
  }
  known[key] = chosen;
  *cl_out = chosen;
  return 0;
}

// One launch of K5 (pre: in = xw, no W_ih or bias) or K6 (in = x).
int launch(bool pre, const bf16* in, const uint2* wih_p, const uint2* whh_p, const float* bias,
           bf16* out, int T, int D, int B, int Din, int H, cudaStream_t stream) {
  int cl;
  const int rc = choose_cluster(H, Din, D, B, pre, &cl);
  if (rc != 0) return rc;
  const Kernel k = pick_kernel(H, cl, pre);
  const Plan plan = lstm_plan(H, ring_cols(H, Din, cl, pre), cl, k.reg_whh, !pre);
  cudaError_t err =
      cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(k, plan, cl, B, D, stream, &attr);
  int whh_smem = plan.whh_smem, wih_smem = plan.wih_smem;
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
// packed w_hh (uint2 words [D, 4H/8, H/16, 32] of pack_gate_fragments), all
// contiguous device tensors, xw 16-byte aligned; H % 16 == 0,
// 16 <= H <= 256.  One launch on ``stream``.  Returns a cudaError_t.
extern "C" int lstm_recurrence(const void* xw, const void* w_hh_packed, void* out, int T, int D,
                               int B, int H, void* stream_ptr) {
  return launch(true, static_cast<const bf16*>(xw), nullptr, static_cast<const uint2*>(w_hh_packed),
                nullptr, static_cast<bf16*>(out), T, D, B, 0, H, static_cast<cudaStream_t>(stream_ptr));
}

// The cluster size lstm_recurrence takes for (B, D, H) on the current
// device, or -1 on a CUDA error.
extern "C" int lstm_recurrence_cluster(int B, int D, int H) {
  int cl;
  return choose_cluster(H, 0, D, B, true, &cl) == 0 ? cl : -1;
}

// Launches of one lstm_resident call (the wrappers count with this).
extern "C" int lstm_resident_launches() { return 1; }

// The cluster size lstm_resident takes for (B, D, Din, H) on the current
// device, or -1 on a CUDA error.
extern "C" int lstm_resident_cluster(int B, int D, int Din, int H) {
  int cl;
  return choose_cluster(H, Din, D, B, false, &cl) == 0 ? cl : -1;
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
  return launch(false, static_cast<const bf16*>(x), static_cast<const uint2*>(w_ih_packed),
                static_cast<const uint2*>(w_hh_packed), static_cast<const float*>(bias),
                static_cast<bf16*>(out), T, D, B, Din, H, static_cast<cudaStream_t>(stream_ptr));
}
