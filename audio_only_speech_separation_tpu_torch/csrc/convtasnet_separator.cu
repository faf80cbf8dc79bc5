// Whole ConvTasNet separator forward for Hopper (sm_90a): encoder,
// bottleneck gLN + 1x1, the R*X dilated Conv1D blocks, mask head,
// mask * enc and decoder, from [B, T', 16] bf16 frames to
// [B, nspk, T', 16] bf16 decoder frames.
//
// Replaces the TPU kernel ops/pallas/convtasnet_block.py::_kernel of the JAX
// package, entered through fused_convtasnet_separator.  The algebra and the
// dtype policy are the same (bf16 matmul operands, f32 accumulation, f32
// elementwise chain and gLN statistics, y rounded to bf16 after each block,
// gLN-2 applied late as y += rstd2 * (v @ (g2*Ws)) + c0 - mean2*rstd2*c1).
//
// What bounds it on this card.  The TPU kernel keeps a whole sample's
// [T', 512] f32 hidden state h resident in fast memory; here a thread block
// has at most 227 KB of shared memory, and gLN's statistics span all of
// (T', H) of a sample, so every block has two grid-wide dependencies: h's
// statistics before the taps, and v's statistics before the next residual
// update.  Each dependency is a kernel boundary, so h goes through device
// memory: per block and frame, 2 KB of f32 h written by P1 and read back by
// P2 (three taps, the shifted two mostly from cache).  That h traffic, not
// the tensor cores, is the floor: 6.3 GB a call at B=8 x 2 s x 16 kHz, about
// 1.9 ms at 3.35 TB/s.  This first version moves h at roughly a third of
// that rate, because every product is staged through shared memory between
// barriers and each thread block reloads its weights (PERF.md has the
// measured breakdown).  The design keeps everything
// else on chip: v is made per 128-channel chunk in registers and goes
// straight into the v @ wsg product in shared memory, so v never reaches
// device memory; y is stored in bf16 and the pending product P in f32
// ([T', 128], a quarter of h's width).
//
// Structure: the C entry point convtasnet_separator launches, on the
// caller's stream,
//   encoder_kernel                  enc = frames @ we (bf16), P = enc @ wsg0,
//                                   stats of enc
//   per block: block_p1_kernel      y += pending update; h = PReLU(y@W1+b1);
//                                   stats of h
//              block_p2_kernel      u = depthwise taps of gLN-1(h), zeros
//                                   outside [0, T'); v = PReLU(u); stats of v;
//                                   P = v @ wsg
//   head_kernel                     last update; mask; * enc; @ wd
// = 2 + 2*nb launches.  Each thread block owns 64 frames of one sample and
// all channels.  Statistics are per-tile (sum, sum of squares) partials in
// a [B, n_tiles, 2] buffer that the next kernel sums in a fixed order: no
// atomics, so a run repeats bit for bit.  The products use bf16 WMMA
// fragments (16x16x16, f32 accumulate) on tiles staged in shared memory;
// wgmma and TMA are left for later.
//
// The same block body also serves the TCN chain of training (entry
// tcn_separator), which replaces the TPU kernel entered through
// ops/pallas/convtasnet_block.py::fused_tcn_separator(save_state=True): x
// [B, T', 128] -> y, plus each block's input y_b in y_hist and each
// block's gLN statistics, which the backward (convtasnet_backward.cu)
// recomputes from.  There P1 reads y_{b-1} from one y_hist slot and
// writes y_b to the next, and tile 0 of each kernel records the statistics
// it has just finished.

#include "convtasnet_common.cuh"

namespace {

constexpr int LDWD = WIN + 8;  // bf16 row stride of a decoder chunk
constexpr int LDD = WIN + 4;   // f32 row stride of the decoder product
constexpr int WD_BYTES = CH * LDWD * 2;     // [128][LDWD] bf16
constexpr int D_BYTES = TILE * LDD * 4;     // [TILE][LDD] f32

constexpr int SMEM_ENC = 2 * A_BYTES + B_BYTES + C_BYTES;
constexpr int SMEM_P1 = A_BYTES + B_BYTES + C_BYTES;
constexpr int SMEM_P2 = A_BYTES + B_BYTES;
constexpr int SMEM_HEAD = 2 * A_BYTES + B_BYTES + C_BYTES + WD_BYTES + D_BYTES;

// How block_p1_kernel forms a block's input y from the previous one.
constexpr int UPD_ADD = 0;    // y_old + r2 * P + shift (a TCN block's residual)
constexpr int UPD_FIRST = 1;  // r2 * P + shift (the bottleneck's output is the first y)
constexpr int UPD_COPY = 2;   // y_old as it is (the chain's input x)

// y = y_old + r2 * P + (c0 - mean2 * r2 * c1) for the tile's rows, rounded
// to bf16, into sA (and into y_out when it is set); rows >= T are zero.
// ``mode`` is UPD_ADD, UPD_FIRST (no y_old) or UPD_COPY (y = y_old; P, cs
// and the statistics are not read).
__device__ __forceinline__ void pending_update(const bf16* y_old, bf16* y_out, const float* P,
                                               const float* cs, float mean2, float r2, int mode,
                                               int t0, int T, bf16* sA) {
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  float sh[4] = {0.f, 0.f, 0.f, 0.f};
  if (mode != UPD_COPY) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sh[k] = cs[4 * cg + k] - mean2 * r2 * cs[C + 4 * cg + k];
  }
  for (int i = 0; i < TILE / 8; ++i) {
    const int r = rg + 8 * i, t = t0 + r;
    const size_t off = (size_t)r * C + 4 * cg;
    float4 yv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) {
      if (mode != UPD_FIRST) yv = unpack4(*reinterpret_cast<const uint2*>(y_old + off));
      if (mode != UPD_COPY) {
        const float4 pv = *reinterpret_cast<const float4*>(P + off);
        yv.x = yv.x + r2 * pv.x + sh[0];
        yv.y = yv.y + r2 * pv.y + sh[1];
        yv.z = yv.z + r2 * pv.z + sh[2];
        yv.w = yv.w + r2 * pv.w + sh[3];
      }
    }
    const uint2 u = pack4(yv.x, yv.y, yv.z, yv.w);
    *reinterpret_cast<uint2*>(sA + r * LDA + 4 * cg) = u;
    if (y_out) *reinterpret_cast<uint2*>(y_out + off) = u;
  }
}

// enc = frames @ we (bf16, stored), P = enc @ wsg0 (f32), stats of enc.
__global__ void __launch_bounds__(THREADS)
encoder_kernel(const bf16* __restrict__ frames, const bf16* __restrict__ we,
               const bf16* __restrict__ wsg0, bf16* __restrict__ enc, float* __restrict__ P,
               float* __restrict__ part, int T, int Tpad, int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sF = reinterpret_cast<bf16*>(smem);
  bf16* sA = reinterpret_cast<bf16*>(smem + A_BYTES);
  bf16* sB = reinterpret_cast<bf16*>(smem + 2 * A_BYTES);
  float* sC = reinterpret_cast<float*>(smem + 2 * A_BYTES + B_BYTES);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < TILE * 2; i += THREADS) {  // two 8-value halves a row
    const int r = i >> 1, c = (i & 1) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) v = *reinterpret_cast<const uint4*>(frames + ((size_t)b * T + t0 + r) * WIN + c);
    *reinterpret_cast<uint4*>(sF + r * LDA + c) = v;
  }
  bf16* enc_t = enc + ((size_t)b * Tpad + t0) * H;
  Acc pacc[4];
  zero_acc(pacc);
  float s = 0.f, q = 0.f;
  for (int ch = 0; ch < H; ch += CH) {
    load_tile(sB, LDA, we + ch, H, WIN, CH);
    __syncthreads();
    Acc acc[4];
    zero_acc(acc);
    mma_tile(acc, sF, sB, WIN);
    store_acc(acc, sC, LDC);
    __syncthreads();
    for (int i = 0; i < TILE / 8; ++i) {
      const int r = rg + 8 * i;
      const float4 c4 = *reinterpret_cast<const float4*>(sC + r * LDC + 4 * cg);
      const uint2 u = pack4(c4.x, c4.y, c4.z, c4.w);
      const float4 e = unpack4(u);  // statistics of the bf16 values
      s += e.x + e.y + e.z + e.w;
      q += e.x * e.x + e.y * e.y + e.z * e.z + e.w * e.w;
      *reinterpret_cast<uint2*>(sA + r * LDA + 4 * cg) = u;
      *reinterpret_cast<uint2*>(enc_t + (size_t)r * H + ch + 4 * cg) = u;
    }
    load_tile(sB, LDA, wsg0 + (size_t)ch * C, C, CH, C);
    __syncthreads();
    mma_tile(pacc, sA, sB, CH);
    __syncthreads();
  }
  store_acc(pacc, P + ((size_t)b * Tpad + t0) * C, C);
  block_sum2_store(s, q, part + ((size_t)b * n_tiles + tile) * 2);
}

// Pending residual update of the previous block (``mode``), then
// h = PReLU(y@W1 + b1) (f32, stored; rows >= T zero) and the per-tile
// statistics of h.  The block's input y is read from y_in and written to
// y_out (the same buffer in the separator; successive y_hist slots in the
// TCN chain), each with its own per-sample stride.  When ``st_prev`` is
// set, tile 0 writes the previous block's (mean2, rstd2) there (per-sample
// stride st_bs).
__global__ void __launch_bounds__(THREADS)
block_p1_kernel(const bf16* y_in, size_t y_in_bs, bf16* y_out, size_t y_out_bs,
                const float* __restrict__ P, const float* __restrict__ part_in,
                float* __restrict__ part_out, const float* __restrict__ cs_prev,
                const bf16* __restrict__ w1, const float* __restrict__ vec,
                const float* __restrict__ alpha, float* __restrict__ h, float* __restrict__ st_prev,
                int st_bs, int mode, int T, int Tpad, int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ms[2];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const float inv_count = 1.f / ((float)T * (float)H);

  if (mode != UPD_COPY) {
    finish_stats(part_in + (size_t)b * n_tiles * 2, n_tiles, inv_count, ms);
    if (st_prev && tile == 0 && threadIdx.x == 0) {
      st_prev[(size_t)b * st_bs] = ms[0];
      st_prev[(size_t)b * st_bs + 1] = ms[1];
    }
  }
  const size_t row0 = (size_t)b * Tpad + t0;
  pending_update(y_in + b * y_in_bs + (size_t)t0 * C, y_out + b * y_out_bs + (size_t)t0 * C,
                 P + row0 * C, cs_prev, ms[0], ms[1], mode, t0, T, sA);

  const float a1 = alpha[0];
  float* h_t = h + row0 * H;
  float s = 0.f, q = 0.f;
  for (int ch = 0; ch < H; ch += CH) {
    load_tile(sB, LDA, w1 + ch, H, C, CH);
    __syncthreads();
    Acc acc[4];
    zero_acc(acc);
    mma_tile(acc, sA, sB, C);
    store_acc(acc, sC, LDC);
    __syncthreads();
    const float4 b1 = *reinterpret_cast<const float4*>(vec + V_B1 * H + ch + 4 * cg);
    for (int i = 0; i < TILE / 8; ++i) {
      const int r = rg + 8 * i;
      float4 z = *reinterpret_cast<const float4*>(sC + r * LDC + 4 * cg);
      if (t0 + r < T) {
        z.x = prelu(z.x + b1.x, a1);
        z.y = prelu(z.y + b1.y, a1);
        z.z = prelu(z.z + b1.z, a1);
        z.w = prelu(z.w + b1.w, a1);
        s += z.x + z.y + z.z + z.w;
        q += z.x * z.x + z.y * z.y + z.z * z.z + z.w * z.w;
      } else {
        z = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      *reinterpret_cast<float4*>(h_t + (size_t)r * H + ch + 4 * cg) = z;
    }
    __syncthreads();
  }
  block_sum2_store(s, q, part_out + ((size_t)b * n_tiles + tile) * 2);
}

// u = dwb + sum_k dw_k * gLN1(h)[t + (k-1)d] (zero outside [0, T)),
// v = PReLU(u), statistics of v, P = bf16(v) @ wsg (f32).  When ``st_cur``
// is set, tile 0 writes this block's (mean1, rstd1) there.
__global__ void __launch_bounds__(THREADS)
block_p2_kernel(const float* __restrict__ h, const float* __restrict__ part_in,
                float* __restrict__ part_out, const float* __restrict__ vec,
                const float* __restrict__ alpha, const bf16* __restrict__ wsg,
                float* __restrict__ P, float* __restrict__ st_cur, int st_bs, int d, int T,
                int Tpad, int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ms[2];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + A_BYTES);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const float inv_count = 1.f / ((float)T * (float)H);

  finish_stats(part_in + (size_t)b * n_tiles * 2, n_tiles, inv_count, ms);
  const float mean1 = ms[0], r1 = ms[1];
  if (st_cur && tile == 0 && threadIdx.x == 0) {
    st_cur[(size_t)b * st_bs] = mean1;
    st_cur[(size_t)b * st_bs + 1] = r1;
  }
  const float a2 = alpha[1];
  const float* h_b = h + (size_t)b * Tpad * H;
  Acc acc[4];
  zero_acc(acc);
  float s = 0.f, q = 0.f;
  for (int ch = 0; ch < H; ch += CH) {
    load_tile(sB, LDA, wsg + (size_t)ch * C, C, CH, C);
    const int col = ch + 4 * cg;
    float sc[4], sh[4], w0[4], w1[4], w2[4], wb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sc[k] = vec[V_G1 * H + col + k] * r1;
      sh[k] = vec[V_BT1 * H + col + k] - mean1 * sc[k];
      w0[k] = vec[V_DW0 * H + col + k];
      w1[k] = vec[V_DW1 * H + col + k];
      w2[k] = vec[V_DW2 * H + col + k];
      wb[k] = vec[V_DWB * H + col + k];
    }
    for (int i = 0; i < TILE / 8; ++i) {
      const int r = rg + 8 * i, t = t0 + r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < T) {
        const float4 hm = *reinterpret_cast<const float4*>(h_b + (size_t)t * H + col);
        float u[4] = {wb[0], wb[1], wb[2], wb[3]};
        if (t - d >= 0) {
          const float4 hl = *reinterpret_cast<const float4*>(h_b + (size_t)(t - d) * H + col);
          u[0] += w0[0] * (hl.x * sc[0] + sh[0]);
          u[1] += w0[1] * (hl.y * sc[1] + sh[1]);
          u[2] += w0[2] * (hl.z * sc[2] + sh[2]);
          u[3] += w0[3] * (hl.w * sc[3] + sh[3]);
        }
        u[0] += w1[0] * (hm.x * sc[0] + sh[0]);
        u[1] += w1[1] * (hm.y * sc[1] + sh[1]);
        u[2] += w1[2] * (hm.z * sc[2] + sh[2]);
        u[3] += w1[3] * (hm.w * sc[3] + sh[3]);
        if (t + d < T) {
          const float4 hr = *reinterpret_cast<const float4*>(h_b + (size_t)(t + d) * H + col);
          u[0] += w2[0] * (hr.x * sc[0] + sh[0]);
          u[1] += w2[1] * (hr.y * sc[1] + sh[1]);
          u[2] += w2[2] * (hr.z * sc[2] + sh[2]);
          u[3] += w2[3] * (hr.w * sc[3] + sh[3]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = prelu(u[k], a2);
          s += v[k];
          q += v[k] * v[k];
        }
      }
      *reinterpret_cast<uint2*>(sA + r * LDA + 4 * cg) = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    mma_tile(acc, sA, sB, CH);
    __syncthreads();
  }
  store_acc(acc, P + ((size_t)b * Tpad + t0) * C, C);
  block_sum2_store(s, q, part_out + ((size_t)b * n_tiles + tile) * 2);
}

// Last pending update, then per speaker: mask = act(y @ wm_k + bm_k),
// db = bf16(mask) * enc, out = db @ wd (bf16), rows < T only.
__global__ void __launch_bounds__(THREADS)
head_kernel(const bf16* __restrict__ y, const float* __restrict__ P,
            const float* __restrict__ part_in, const float* __restrict__ cs_prev,
            const bf16* __restrict__ wm, const float* __restrict__ bm,
            const bf16* __restrict__ enc, const bf16* __restrict__ wd, bf16* __restrict__ out,
            int nspk, int sigmoid, int mode, int T, int Tpad, int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ms[2];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sA2 = reinterpret_cast<bf16*>(smem + A_BYTES);
  bf16* sB = reinterpret_cast<bf16*>(smem + 2 * A_BYTES);
  float* sC = reinterpret_cast<float*>(smem + 2 * A_BYTES + B_BYTES);
  bf16* sWD = reinterpret_cast<bf16*>(smem + 2 * A_BYTES + B_BYTES + C_BYTES);
  float* sD = reinterpret_cast<float*>(smem + 2 * A_BYTES + B_BYTES + C_BYTES + WD_BYTES);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5, w = threadIdx.x >> 5;
  const float inv_count = 1.f / ((float)T * (float)H);

  finish_stats(part_in + (size_t)b * n_tiles * 2, n_tiles, inv_count, ms);
  const size_t row0 = (size_t)b * Tpad + t0;
  pending_update(y + row0 * C, nullptr, P + row0 * C, cs_prev, ms[0], ms[1], mode, t0, T, sA);
  const bf16* enc_t = enc + row0 * H;

  for (int k = 0; k < nspk; ++k) {
    Acc dacc;
    wmma::fill_fragment(dacc, 0.f);
    for (int ch = 0; ch < H; ch += CH) {
      load_tile(sB, LDA, wm + (size_t)k * H + ch, nspk * H, C, CH);
      load_tile(sWD, LDWD, wd + (size_t)ch * WIN, WIN, CH, WIN);
      __syncthreads();
      Acc acc[4];
      zero_acc(acc);
      mma_tile(acc, sA, sB, C);
      store_acc(acc, sC, LDC);
      __syncthreads();
      const float4 bv = *reinterpret_cast<const float4*>(bm + (size_t)k * H + ch + 4 * cg);
      for (int i = 0; i < TILE / 8; ++i) {
        const int r = rg + 8 * i;
        const float4 z = *reinterpret_cast<const float4*>(sC + r * LDC + 4 * cg);
        float m[4] = {z.x + bv.x, z.y + bv.y, z.z + bv.z, z.w + bv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = sigmoid ? 1.f / (1.f + expf(-m[j])) : fmaxf(m[j], 0.f);
        const float4 mb = unpack4(pack4(m[0], m[1], m[2], m[3]));
        const float4 e =
            unpack4(*reinterpret_cast<const uint2*>(enc_t + (size_t)r * H + ch + 4 * cg));
        *reinterpret_cast<uint2*>(sA2 + r * LDA + 4 * cg) =
            pack4(mb.x * e.x, mb.y * e.y, mb.z * e.z, mb.w * e.w);
      }
      __syncthreads();
      if (w < 4) {
        for (int kk = 0; kk < CH; kk += 16) {
          FragA a;
          FragB bb;
          wmma::load_matrix_sync(a, sA2 + w * 16 * LDA + kk, LDA);
          wmma::load_matrix_sync(bb, sWD + kk * LDWD, LDWD);
          wmma::mma_sync(dacc, a, bb, dacc);
        }
      }
      __syncthreads();
    }
    if (w < 4) wmma::store_matrix_sync(sD + w * 16 * LDD, dacc, LDD, wmma::mem_row_major);
    __syncthreads();
    bf16* out_k = out + ((size_t)b * nspk + k) * T * WIN;
    for (int i = threadIdx.x; i < TILE * (WIN / 4); i += THREADS) {
      const int r = i / (WIN / 4), c = (i % (WIN / 4)) * 4;
      if (t0 + r < T) {
        const float* src = sD + r * LDD + c;
        *reinterpret_cast<uint2*>(out_k + (size_t)(t0 + r) * WIN + c) =
            pack4(src[0], src[1], src[2], src[3]);
      }
    }
    __syncthreads();
  }
}

// The TCN chain's last pending update: out[t] = y_last[t] + r2 * P[t] +
// (c0 - mean2 * r2 * c1) in bf16 for t < T (out is [B, T, 128]); tile 0
// writes the last block's (mean2, rstd2) to st_prev.
__global__ void __launch_bounds__(THREADS)
tcn_epilogue_kernel(const bf16* __restrict__ y_in, size_t y_in_bs, bf16* __restrict__ out,
                    const float* __restrict__ P, const float* __restrict__ part_in,
                    const float* __restrict__ cs_prev, float* __restrict__ st_prev, int st_bs,
                    int T, int Tpad, int H, int n_tiles) {
  __shared__ float ms[2];
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  finish_stats(part_in + (size_t)b * n_tiles * 2, n_tiles, 1.f / ((float)T * (float)H), ms);
  const float mean2 = ms[0], r2 = ms[1];
  if (tile == 0 && threadIdx.x == 0) {
    st_prev[(size_t)b * st_bs] = mean2;
    st_prev[(size_t)b * st_bs + 1] = r2;
  }
  float sh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) sh[k] = cs_prev[4 * cg + k] - mean2 * r2 * cs_prev[C + 4 * cg + k];
  for (int i = 0; i < TILE / 8; ++i) {
    const int t = t0 + rg + 8 * i;
    if (t >= T) break;
    const float4 pv = *reinterpret_cast<const float4*>(P + ((size_t)b * Tpad + t) * C + 4 * cg);
    float4 yv = unpack4(*reinterpret_cast<const uint2*>(y_in + b * y_in_bs + (size_t)t * C + 4 * cg));
    yv.x = yv.x + r2 * pv.x + sh[0];
    yv.y = yv.y + r2 * pv.y + sh[1];
    yv.z = yv.z + r2 * pv.z + sh[2];
    yv.w = yv.w + r2 * pv.w + sh[3];
    *reinterpret_cast<uint2*>(out + ((size_t)b * T + t) * C + 4 * cg) = pack4(yv.x, yv.y, yv.z, yv.w);
  }
}

}  // namespace

extern "C" const char* convtasnet_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The whole separator on ``stream``: 2 + 2*nb kernel launches.  Pointers
// are device pointers to contiguous tensors (see the Python wrapper for
// shapes); ``dils`` is a host array of nb dilations.  Scratch: enc
// [B, Tpad, H] bf16, y [B, Tpad, 128] bf16, h [B, Tpad, H] f32,
// p [B, Tpad, 128] f32, part1/part2 [B, n_tiles, 2] f32, with
// n_tiles = ceil(T / 64) and Tpad = 64 * n_tiles.  Returns a cudaError_t.
extern "C" int convtasnet_separator(const void* frames, const void* we, const void* w1s,
                                    const void* wsgs, const void* vecs, const void* cs,
                                    const void* alphas, const void* wm, const void* bm,
                                    const void* wd, void* out, void* enc, void* y, void* h,
                                    void* p, void* part1, void* part2, int B, int T, int H,
                                    int nb, const int* dils, int nspk, int sigmoid,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (T + TILE - 1) / TILE, Tpad = n_tiles * TILE;
  RETURN_IF_ERROR(cudaFuncSetAttribute(encoder_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ENC));
  RETURN_IF_ERROR(cudaFuncSetAttribute(block_p1_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_P1));
  RETURN_IF_ERROR(cudaFuncSetAttribute(block_p2_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_P2));
  RETURN_IF_ERROR(cudaFuncSetAttribute(head_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_HEAD));
  const bf16* w1s_ = static_cast<const bf16*>(w1s);
  const bf16* wsgs_ = static_cast<const bf16*>(wsgs);
  const float* vecs_ = static_cast<const float*>(vecs);
  const float* cs_ = static_cast<const float*>(cs);
  const float* alphas_ = static_cast<const float*>(alphas);
  bf16* y_ = static_cast<bf16*>(y);
  float* h_ = static_cast<float*>(h);
  float* p_ = static_cast<float*>(p);
  float* part1_ = static_cast<float*>(part1);
  float* part2_ = static_cast<float*>(part2);
  const dim3 grid(n_tiles, B);

  encoder_kernel<<<grid, THREADS, SMEM_ENC, stream>>>(
      static_cast<const bf16*>(frames), static_cast<const bf16*>(we), wsgs_,
      static_cast<bf16*>(enc), p_, part2_, T, Tpad, H, n_tiles);
  RETURN_IF_ERROR(cudaGetLastError());
  const size_t ybs = (size_t)Tpad * C;
  for (int blk = 1; blk <= nb; ++blk) {
    block_p1_kernel<<<grid, THREADS, SMEM_P1, stream>>>(
        y_, ybs, y_, ybs, p_, part2_, part1_, cs_ + (size_t)(blk - 1) * 2 * C,
        w1s_ + (size_t)blk * C * H, vecs_ + (size_t)blk * 8 * H, alphas_ + 2 * blk, h_, nullptr,
        0, blk == 1 ? UPD_FIRST : UPD_ADD, T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    block_p2_kernel<<<grid, THREADS, SMEM_P2, stream>>>(
        h_, part1_, part2_, vecs_ + (size_t)blk * 8 * H, alphas_ + 2 * blk,
        wsgs_ + (size_t)blk * H * C, p_, nullptr, 0, dils[blk - 1], T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  head_kernel<<<grid, THREADS, SMEM_HEAD, stream>>>(
      y_, p_, part2_, cs_ + (size_t)nb * 2 * C, static_cast<const bf16*>(wm),
      static_cast<const float*>(bm), static_cast<const bf16*>(enc), static_cast<const bf16*>(wd),
      static_cast<bf16*>(out), nspk, sigmoid, nb == 0 ? UPD_FIRST : UPD_ADD, T, Tpad, H,
      n_tiles);
  RETURN_IF_ERROR(cudaGetLastError());
  return 0;
}

// The TCN chain alone (the forward of training) on ``stream``: per block
// block_p1_kernel + block_p2_kernel, then tcn_epilogue_kernel = 2*nb + 1
// launches.  x [B, T, 128] bf16 -> y [B, T, 128] bf16, and the state the
// backward needs: y_hist [B, nb, Tpad, 128] bf16, each block's input
// (y_hist[:, 0] = x; rows >= T zero), and stats [B, nb, 4] f32, each
// block's (mean1, rstd1, mean2, rstd2).  Block b's P1 reads y_hist[:, b-1]
// and writes y_hist[:, b], so the history is the chain's only y buffer.
// Scratch: h [B, Tpad, H] f32, p [B, Tpad, 128] f32, part1/part2
// [B, n_tiles, 2] f32.  nb >= 1.  Returns a cudaError_t.
extern "C" int tcn_separator(const void* x, const void* w1s, const void* wsgs, const void* vecs,
                             const void* cs, const void* alphas, void* y, void* y_hist,
                             void* stats, void* h, void* p, void* part1, void* part2, int B,
                             int T, int H, int nb, const int* dils, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (T + TILE - 1) / TILE, Tpad = n_tiles * TILE;
  RETURN_IF_ERROR(cudaFuncSetAttribute(block_p1_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_P1));
  RETURN_IF_ERROR(cudaFuncSetAttribute(block_p2_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_P2));
  const bf16* w1s_ = static_cast<const bf16*>(w1s);
  const bf16* wsgs_ = static_cast<const bf16*>(wsgs);
  const float* vecs_ = static_cast<const float*>(vecs);
  const float* cs_ = static_cast<const float*>(cs);
  const float* alphas_ = static_cast<const float*>(alphas);
  bf16* yh = static_cast<bf16*>(y_hist);
  float* st = static_cast<float*>(stats);
  float* h_ = static_cast<float*>(h);
  float* p_ = static_cast<float*>(p);
  float* part1_ = static_cast<float*>(part1);
  float* part2_ = static_cast<float*>(part2);
  const dim3 grid(n_tiles, B);
  const size_t slot = (size_t)Tpad * C, hbs = (size_t)nb * slot;
  const int st_bs = 4 * nb;

  for (int blk = 0; blk < nb; ++blk) {
    const bf16* y_in = blk == 0 ? static_cast<const bf16*>(x) : yh + (blk - 1) * slot;
    block_p1_kernel<<<grid, THREADS, SMEM_P1, stream>>>(
        y_in, blk == 0 ? (size_t)T * C : hbs, yh + blk * slot, hbs, p_, part2_, part1_,
        cs_ + (size_t)(blk > 0 ? blk - 1 : 0) * 2 * C, w1s_ + (size_t)blk * C * H,
        vecs_ + (size_t)blk * 8 * H, alphas_ + 2 * blk, h_,
        blk > 0 ? st + 4 * (blk - 1) + 2 : nullptr, st_bs, blk == 0 ? UPD_COPY : UPD_ADD, T,
        Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    block_p2_kernel<<<grid, THREADS, SMEM_P2, stream>>>(
        h_, part1_, part2_, vecs_ + (size_t)blk * 8 * H, alphas_ + 2 * blk,
        wsgs_ + (size_t)blk * H * C, p_, st + 4 * blk, st_bs, dils[blk], T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  tcn_epilogue_kernel<<<grid, THREADS, 0, stream>>>(
      yh + (nb - 1) * slot, hbs, static_cast<bf16*>(y), p_, part2_, cs_ + (size_t)(nb - 1) * 2 * C,
      st + 4 * (nb - 1) + 2, st_bs, T, Tpad, H, n_tiles);
  RETURN_IF_ERROR(cudaGetLastError());
  return 0;
}
