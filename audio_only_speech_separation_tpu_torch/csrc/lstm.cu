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
// What bounds it on this card.  The recurrence is serial in t: each step is
// a [16, H] x [H, 4H] product per batch tile that cannot start before the
// previous step's h exists, so the time is T steps of latency (a shared-
// memory product, two barriers and the gate math), not bytes or FLOPs.  At
// the dual-path shapes (H = 128) the whole call moves a few MB and does a
// few GFLOP, microseconds of either.  The design keeps the recurrence on
// chip: a thread block owns one direction and 16 batch rows for all T
// steps; W_hh of its direction sits in shared memory when it fits (128 KB
// bf16 at H = 128, with the 227 KB limit raised by cudaFuncSetAttribute),
// otherwise it is read from L2; h stays in shared memory and c in
// registers; the gate inputs of step t are the only per-step reads (xw for
// the recurrence, one [16, Din] row block of x for the resident form, whose
// W_ih is read from L2 to leave W_hh the shared memory).  Products are bf16
// WMMA 16x16x16.  Rows past B are masked: their x and h are zero and their
// outputs are not written.  Nothing here tunes the serial loop yet; at
// batch 1 an inter-chunk pass has 7 blocks a direction.
//
// One launch a call; the grid is (batch tiles, directions).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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

// h [T, D, B, H] from x [B, T, Din] bf16, w_ih [D, Din, 4H] bf16, w_hh
// [D, H, 4H] bf16 and bias [D, 4H] f32, all contiguous device tensors;
// Din % 16 == 0, H % 16 == 0, H <= 256.  Direction 1 runs backward in time
// and writes its output time-aligned.  One launch on ``stream``.  Returns a
// cudaError_t.
extern "C" int lstm_resident(const void* x, const void* w_ih, const void* w_hh, const void* bias,
                             void* out, int T, int D, int B, int Din, int H, void* stream_ptr) {
  return launch<true>(nullptr, static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih),
                      static_cast<const bf16*>(w_hh), static_cast<const float*>(bias),
                      static_cast<bf16*>(out), T, D, B, H, Din,
                      static_cast<cudaStream_t>(stream_ptr));
}
