// Backward of the ConvTasNet TCN chain for Hopper (sm_90a): the reverse
// walk over the R*X dilated Conv1D blocks, from the cotangent g of the
// chain output to dx and the packed weight gradients.
//
// Replaces the TPU kernel ops/pallas/convtasnet_backward.py::_bwd_kernel of
// the JAX package, entered through fused_tcn_backward.  Same algebra (the
// docstring there, :25-46): per block b, walking in reverse, recompute
// z = y_b @ W1 + b1, h = PReLU(z), u (the depthwise taps of gLN-1(h)) and
// v = PReLU(u) from the saved block input y_b and the saved statistics;
// recover the pending product as P = (y_{b+1} - y_b - shift) / r2; then
//   A = sum g*P, S_g = sum_t g               -> dr2, dmu2, dcs
//   dv = r2 * (g @ Wsg^T) + dmu2/(TH) + v * 2 dq2/(TH);  du = PReLU'(u) dv
//   T_k = sum_t du * h[t + (k-1)d], S_u and its edge sums  -> dr1, dmu1, dvecs
//   dh[t] = sum_k dw_k sc1 du[t - (k-1)d] + dmu1/(TH) + h * 2 dq1/(TH)
//   dz = PReLU'(z) dh;  dW1 = y_b^T dz;  dWsg = r2 v^T g;  g <- g + dz @ W1^T.
// Unlike the TPU kernel, z and u stay f32 in the recompute (it stores z in
// bf16), and the taps read zeros outside [0, T') as the forward does.
//
// What bounds it on this card.  The TPU kernel walks one sample's blocks in
// one program with h, du and the cotangent resident in 100 MB of VMEM, and
// accumulates the weight gradients sample after sample in revisited
// outputs.  Here thread blocks own 64 frames of one sample and run at once,
// so each block of the chain has three grid-wide dependencies: A and S_g
// before dv, the tap and edge sums before dh, and the weight gradients over
// all B*T' rows.  Each is a kernel boundary, and z, du and v/dz go through
// device memory (the taps read du and h at t +- d).  The function's own
// bound is its five products (1.5 ms at B=12 x 2 s x 16 kHz); the first
// port took 38 ms: a third in WMMA weight-gradient products at ~5 % of the
// bf16 peak (synchronous tile copies, ~19 MB of split-K partials summed
// one thread per output), over half in the streaming passes, and
// per-sample finishing sums on only B thread blocks.
//
// What the design does about it.
// - The weight gradients of a block (dWsg and dW1) are one launch of an
//   mma.sync m16n8k16 product fed by a 4-stage cp.async ring of 32-row
//   tiles (ldmatrix.trans from padded rows, no bank conflicts), 128 x 128
//   output tiles split over the rows of each sample (at most two thread
//   blocks an SM); a split's partial is scaled by its sample's r2 (dWsg) as
//   it is stored, and one launch sums the partials in a fixed order.
// - The finishing sums run on (sample x 32-channel chunk) thread blocks,
//   or 8 groups a sample; bwd_p3 sums the chunks' partials of dr1 and of
//   dmu1's mean term itself; db1 and da1 are summed in the launch that sums
//   the weight-gradient partials.
// No atomics: every sum runs in a fixed order, so two runs are
// bit-identical.
//
// Per block of the chain: bwd_p1, stats2_finish, bwd_p2, stats1_finish,
// bwd_p3, wgrad (both products), block_finish = 7 launches; two
// sum_samples launches at the end: tcn_backward_launches(nb) = 7*nb + 2.

#include "convtasnet_common.cuh"

namespace {

constexpr int NQ = 6;        // T0, T1, T2, S_u, S_u(head), S_u(tail)
constexpr int WG_K = 32;      // rows per stage of the weight-gradient product
constexpr int WG_T = 128;     // its output tile is WG_T x WG_T
constexpr int LDW = WG_T + 8;  // bf16 row stride of its staged tiles
constexpr int WG_STAGES = 4;  // cp.async ring depth
constexpr int WG_STAGE = 2 * WG_K * LDW;         // bf16 elements a stage (A and Bm)
constexpr int SMEM_WG = WG_STAGES * WG_STAGE * 2;  // 69,632 bytes

constexpr int RED_BYTES = NWARPS * CH * 4;  // [8][128] f32
constexpr int SMEM_BP1 = A_BYTES + B_BYTES + C_BYTES + RED_BYTES;
constexpr int SMEM_BP2 = A_BYTES + B_BYTES + C_BYTES + NQ * RED_BYTES;
constexpr int SMEM_BP3 = A_BYTES + B_BYTES + C_BYTES + RED_BYTES;

// Sum red[w][c] over the 8 warps for c < 128 in order; thread c stores
// out[c].  red is [NWARPS][CH].
__device__ __forceinline__ void reduce_warps_store(const float* red, float* out) {
  if (threadIdx.x < CH) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w * CH + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// One thread block per (tile, sample).  Recomputes z = y_b @ W1 + b1 (f32,
// all Tpad rows); from g, y_b and y_{b+1} the partials of A = sum g*P and
// S_g = sum_t g, with P = (y_{b+1} - y_b - shift) / r2; gb = bf16(g).
__global__ void __launch_bounds__(THREADS)
bwd_p1_kernel(const float* __restrict__ g, const bf16* __restrict__ y_cur, size_t ycur_bs,
              const bf16* __restrict__ y_next, size_t ynext_bs, const float* __restrict__ st,
              int st_bs, const float* __restrict__ cs, const bf16* __restrict__ w1,
              const float* __restrict__ vec, float* __restrict__ z, bf16* __restrict__ gb,
              float* __restrict__ partA, float* __restrict__ partSg, int T, int Tpad, int H,
              int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);
  float* red = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES + C_BYTES);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const float mean2 = st[(size_t)b * st_bs + 2], r2 = st[(size_t)b * st_bs + 3];
  const float inv_r2 = 1.f / r2;
  float sh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) sh[k] = cs[4 * cg + k] - mean2 * r2 * cs[C + 4 * cg + k];

  const bf16* yc = y_cur + b * ycur_bs;
  const bf16* yn = y_next + b * ynext_bs;
  const size_t row0 = (size_t)b * Tpad + t0;
  float a_loc = 0.f, sg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < TILE / 8; ++i) {
    const int r = rg + 8 * i, t = t0 + r;
    uint2 ycu = make_uint2(0u, 0u), gu = make_uint2(0u, 0u);
    if (t < T) {
      ycu = *reinterpret_cast<const uint2*>(yc + (size_t)t * C + 4 * cg);
      const float4 gv = *reinterpret_cast<const float4*>(g + (row0 + r) * C + 4 * cg);
      const float4 y0 = unpack4(ycu);
      const float4 y1 = unpack4(*reinterpret_cast<const uint2*>(yn + (size_t)t * C + 4 * cg));
      a_loc += gv.x * ((y1.x - y0.x - sh[0]) * inv_r2) + gv.y * ((y1.y - y0.y - sh[1]) * inv_r2) +
               gv.z * ((y1.z - y0.z - sh[2]) * inv_r2) + gv.w * ((y1.w - y0.w - sh[3]) * inv_r2);
      sg[0] += gv.x;
      sg[1] += gv.y;
      sg[2] += gv.z;
      sg[3] += gv.w;
      gu = pack4(gv.x, gv.y, gv.z, gv.w);
    }
    *reinterpret_cast<uint2*>(sA + r * LDA + 4 * cg) = ycu;
    *reinterpret_cast<uint2*>(gb + (row0 + r) * C + 4 * cg) = gu;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) red[rg * CH + 4 * cg + k] = sg[k];
  __syncthreads();
  reduce_warps_store(red, partSg + ((size_t)b * n_tiles + tile) * C);
  block_sum2_store(a_loc, 0.f, partA + ((size_t)b * n_tiles + tile) * 2);

  float* z_t = z + row0 * H;
  for (int ch = 0; ch < H; ch += CH) {
    load_tile(sB, LDA, w1 + ch, H, C, CH);
    __syncthreads();
    Acc acc[4];
    zero_acc(acc);
    mma_tile(acc, sA, sB, C);
    store_acc(acc, sC, LDC);
    __syncthreads();
    const float4 b1 = *reinterpret_cast<const float4*>(vec + V_B1 * H + ch + 4 * cg);
#pragma unroll 4
    for (int i = 0; i < TILE / 8; ++i) {
      const int r = rg + 8 * i;
      float4 zv = *reinterpret_cast<const float4*>(sC + r * LDC + 4 * cg);
      zv.x = zv.x + b1.x;
      zv.y = zv.y + b1.y;
      zv.z = zv.z + b1.z;
      zv.w = zv.w + b1.w;
      *reinterpret_cast<float4*>(z_t + (size_t)r * H + ch + 4 * cg) = zv;
    }
    __syncthreads();
  }
}

// One thread block per sample, 8 groups of 128 threads (one per channel):
// A and S_g from their per-tile partials (group w sums the tiles i = w
// mod 8, then the groups in order); the per-sample scalars (al2, be2) of
// dv; this sample's dc0 = S_g and dc1 = -mean2 * r2 * S_g.
__global__ void __launch_bounds__(8 * C)
stats2_finish_kernel(const float* __restrict__ partA, const float* __restrict__ partSg,
                     const float* __restrict__ st, int st_bs, const float* __restrict__ cs,
                     float* __restrict__ coef, float* __restrict__ dcs_s, size_t dcs_bs, int T,
                     int H, int n_tiles) {
  __shared__ float red[8][C];
  const int b = blockIdx.x, c = threadIdx.x % C, grp = threadIdx.x / C;
  const float mean2 = st[(size_t)b * st_bs + 2], r2 = st[(size_t)b * st_bs + 3];
  const float inv = 1.f / ((float)T * (float)H);
  float sg = 0.f, a = 0.f;
  for (int i = grp; i < n_tiles; i += 8) sg += partSg[((size_t)b * n_tiles + i) * C + c];
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) a += partA[((size_t)b * n_tiles + i) * 2];
  red[grp][c] = sg;
  __syncthreads();
  sg = 0.f;
  for (int w = 0; w < 8; ++w) sg += red[w][c];
  a = block_allreduce(a);
  const float sgc1 = block_allreduce(grp == 0 ? sg * cs[C + c] : 0.f);
  const float dr2 = a - mean2 * sgc1;
  const float r2c = r2 * r2 * r2;
  const float dmu2 = -r2 * sgc1 + dr2 * mean2 * r2c;
  const float dq2 = -0.5f * dr2 * r2c;
  if (threadIdx.x == 0) {
    coef[(size_t)b * 4] = dmu2 * inv;
    coef[(size_t)b * 4 + 1] = 2.f * dq2 * inv;
  }
  if (grp == 0) {
    float* out = dcs_s + b * dcs_bs;
    out[c] = sg;
    out[C + c] = -mean2 * r2 * sg;
  }
}

// One thread block per (tile, sample).  Recomputes u and v from z, forms
// dv = r2 * (gb @ Wsg^T) + al2 + be2 * v and du = PReLU'(u) dv (rows >= T
// zero), stores du (f32) and bf16(v), and writes the per-tile partials of
// T_k, S_u and its edge sums (per channel) and of da2 = sum dv * min(u, 0).
__global__ void __launch_bounds__(THREADS)
bwd_p2_kernel(const float* __restrict__ z, const bf16* __restrict__ gb,
              const float* __restrict__ st, int st_bs, const float* __restrict__ vec,
              const float* __restrict__ alpha, const bf16* __restrict__ wsg,
              const float* __restrict__ coef, float* __restrict__ du, bf16* __restrict__ vb,
              float* __restrict__ part6, float* __restrict__ partDa2, int d, int T, int Tpad,
              int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);
  float* red = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES + C_BYTES);  // [NQ][8][128]
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const float* stb = st + (size_t)b * st_bs;
  const float mean1 = stb[0], r1 = stb[1], r2 = stb[3];
  const float al2 = coef[(size_t)b * 4], be2 = coef[(size_t)b * 4 + 1];
  const float a1 = alpha[0], a2 = alpha[1];
  const size_t row0 = (size_t)b * Tpad + t0;
  const float* z_b = z + (size_t)b * Tpad * H;

  load_tile(sA, LDA, gb + row0 * C, C, TILE, C);
  float da2 = 0.f;
  for (int ch = 0; ch < H; ch += CH) {
    load_tile(sB, LDA, wsg + (size_t)ch * C, C, CH, C);  // rows h of the chunk, all c
    __syncthreads();
    Acc acc[4];
    zero_acc(acc);
    mma_tile_bt(acc, sA, sB, C);
    store_acc(acc, sC, LDC);
    __syncthreads();
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
    float q[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) q[j][k] = 0.f;
#pragma unroll 4
    for (int i = 0; i < TILE / 8; ++i) {
      const int r = rg + 8 * i, t = t0 + r;
      float dus[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < T) {
        const float4 zm = *reinterpret_cast<const float4*>(z_b + (size_t)t * H + col);
        const float hm[4] = {prelu(zm.x, a1), prelu(zm.y, a1), prelu(zm.z, a1), prelu(zm.w, a1)};
        float hl[4] = {0.f, 0.f, 0.f, 0.f}, hr[4] = {0.f, 0.f, 0.f, 0.f};
        float u[4] = {wb[0], wb[1], wb[2], wb[3]};
        if (t - d >= 0) {  // same order of operations as the forward's P2
          const float4 zl = *reinterpret_cast<const float4*>(z_b + (size_t)(t - d) * H + col);
          hl[0] = prelu(zl.x, a1);
          hl[1] = prelu(zl.y, a1);
          hl[2] = prelu(zl.z, a1);
          hl[3] = prelu(zl.w, a1);
#pragma unroll
          for (int k = 0; k < 4; ++k) u[k] += w0[k] * (hl[k] * sc[k] + sh[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) u[k] += w1[k] * (hm[k] * sc[k] + sh[k]);
        if (t + d < T) {
          const float4 zr = *reinterpret_cast<const float4*>(z_b + (size_t)(t + d) * H + col);
          hr[0] = prelu(zr.x, a1);
          hr[1] = prelu(zr.y, a1);
          hr[2] = prelu(zr.z, a1);
          hr[3] = prelu(zr.w, a1);
#pragma unroll
          for (int k = 0; k < 4; ++k) u[k] += w2[k] * (hr[k] * sc[k] + sh[k]);
        }
        const float* pc = sC + r * LDC + 4 * cg;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = prelu(u[k], a2);
          const float dv = r2 * pc[k] + al2 + be2 * v[k];
          dus[k] = u[k] >= 0.f ? dv : a2 * dv;
          da2 += dv * fminf(u[k], 0.f);
          q[0][k] += dus[k] * hl[k];  // hl is 0 where t - d < 0
          q[1][k] += dus[k] * hm[k];
          q[2][k] += dus[k] * hr[k];  // hr is 0 where t + d >= T
          q[3][k] += dus[k];
          if (t < d) q[4][k] += dus[k];
          if (t >= T - d) q[5][k] += dus[k];
        }
      }
      *reinterpret_cast<float4*>(du + (row0 + r) * H + col) = make_float4(dus[0], dus[1], dus[2], dus[3]);
      *reinterpret_cast<uint2*>(vb + (row0 + r) * H + col) = pack4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) red[(j * NWARPS + rg) * CH + 4 * cg + k] = q[j][k];
    __syncthreads();
    for (int idx = threadIdx.x; idx < NQ * CH; idx += THREADS) {
      const int j = idx / CH, c = idx - j * CH;
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += red[(j * NWARPS + w) * CH + c];
      part6[(((size_t)b * n_tiles + tile) * NQ + j) * H + ch + c] = s;
    }
    __syncthreads();
  }
  block_sum2_store(da2, 0.f, partDa2 + ((size_t)b * n_tiles + tile) * 2);
}

// One thread block (8 warps) per (32-channel chunk, sample): the tap and
// edge sums from their per-tile partials (warp w sums the tiles i = w mod
// 8, then the warps in order); this sample's dvecs rows (dwb, dw0..2,
// beta1, gamma1) for the chunk, and the chunk's partials of dr1 and of the
// mean term of dmu1 (coefpart; bwd_p3 sums them); da2 from the first chunk.
__global__ void __launch_bounds__(THREADS)
stats1_finish_kernel(const float* __restrict__ part6, const float* __restrict__ partDa2,
                     const float* __restrict__ st, int st_bs, const float* __restrict__ vec,
                     float* __restrict__ coefpart, float* __restrict__ dvec_s, size_t dvec_bs,
                     int H, int n_tiles) {
  __shared__ float red[NWARPS][NQ][32];
  const int chunk = blockIdx.x, b = blockIdx.y, nchunk = gridDim.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, c = 32 * chunk + lane;
  float q[NQ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = w; i < n_tiles; i += NWARPS) {
    const float* p = part6 + ((size_t)b * n_tiles + i) * NQ * H + c;
#pragma unroll
    for (int j = 0; j < NQ; ++j) q[j] += p[(size_t)j * H];
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) red[w][j][lane] = q[j];
  __syncthreads();
  float* out = dvec_s + b * dvec_bs;
  if (w == 0) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      q[j] = 0.f;
      for (int k = 0; k < NWARPS; ++k) q[j] += red[k][j][lane];
    }
    const float mean1 = st[(size_t)b * st_bs], r1 = st[(size_t)b * st_bs + 1];
    const float g1 = vec[V_G1 * H + c], bt1 = vec[V_BT1 * H + c];
    const float d0 = vec[V_DW0 * H + c], d1 = vec[V_DW1 * H + c], d2 = vec[V_DW2 * H + c];
    const float sc1 = g1 * r1, sh1 = bt1 - mean1 * sc1;
    const float su = q[3], suh = q[4], sut = q[5];
    const float dsh1 = (d0 + d1 + d2) * su - d0 * suh - d2 * sut;
    const float dsc1 = (d0 * q[0] + d1 * q[1] + d2 * q[2]) - mean1 * dsh1;
    out[V_DWB * H + c] = su;
    out[V_DW0 * H + c] = sc1 * q[0] + sh1 * (su - suh);
    out[V_DW1 * H + c] = sc1 * q[1] + sh1 * su;
    out[V_DW2 * H + c] = sc1 * q[2] + sh1 * (su - sut);
    out[V_BT1 * H + c] = dsh1;
    out[V_G1 * H + c] = r1 * dsc1;
    const float acc_r = warp_sum(g1 * dsc1), acc_m = warp_sum(sc1 * dsh1);
    if (lane == 0) {
      coefpart[((size_t)b * nchunk + chunk) * 2] = acc_r;
      coefpart[((size_t)b * nchunk + chunk) * 2 + 1] = acc_m;
    }
  } else if (w == 1 && chunk == 0) {
    float da2 = 0.f;
    for (int i = lane; i < n_tiles; i += 32) da2 += partDa2[((size_t)b * n_tiles + i) * 2];
    da2 = warp_sum(da2);
    if (lane == 0) out[7 * H + 1] = da2;
  }
}

// One thread block per (tile, sample).  dh from du at t, t +- d and h at t;
// dz = PReLU'(z) dh (rows >= T zero), stored in bf16; the per-tile partials
// of db1 = sum_t dz (per channel) and da1 = sum dh * min(z, 0); and
// g <- g + bf16(dz) @ W1^T for the rows < T (the cotangent of block b-1).
// The per-sample scalars (al1, be1) of dh come from stats1_finish's chunk
// partials, summed here in order.
__global__ void __launch_bounds__(THREADS)
bwd_p3_kernel(const float* __restrict__ du, const float* __restrict__ z,
              const float* __restrict__ st, int st_bs, const float* __restrict__ vec,
              const float* __restrict__ alpha, const bf16* __restrict__ w1,
              const float* __restrict__ coefpart, float* __restrict__ g, bf16* __restrict__ dzb,
              float* __restrict__ partDb1, float* __restrict__ partDa1, int d, int T, int Tpad,
              int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);
  float* red = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES + C_BYTES);
  const int tile = blockIdx.x, b = blockIdx.y, t0 = tile * TILE;
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const float mean1 = st[(size_t)b * st_bs], r1 = st[(size_t)b * st_bs + 1];
  float dr1 = 0.f, smu = 0.f;  // the chunk partials of stats1_finish, in order
  for (int k = 0; k < H / 32; ++k) {
    dr1 += coefpart[((size_t)b * (H / 32) + k) * 2];
    smu += coefpart[((size_t)b * (H / 32) + k) * 2 + 1];
  }
  const float r1c = r1 * r1 * r1, inv = 1.f / ((float)T * (float)H);
  const float al1 = (-smu + dr1 * mean1 * r1c) * inv, be1 = 2.f * (-0.5f * dr1 * r1c) * inv;
  const float a1 = alpha[0];
  const size_t row0 = (size_t)b * Tpad + t0;
  const float* du_b = du + (size_t)b * Tpad * H;
  const float* z_b = z + (size_t)b * Tpad * H;

  Acc acc[4];
  zero_acc(acc);
  float da1 = 0.f;
  for (int ch = 0; ch < H; ch += CH) {
    load_tile(sB, LDA, w1 + ch, H, C, CH);  // [c][h of the chunk]
    const int col = ch + 4 * cg;
    float c0[4], c1[4], c2[4], db1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float sc1 = vec[V_G1 * H + col + k] * r1;
      c0[k] = vec[V_DW0 * H + col + k] * sc1;
      c1[k] = vec[V_DW1 * H + col + k] * sc1;
      c2[k] = vec[V_DW2 * H + col + k] * sc1;
    }
#pragma unroll 4
    for (int i = 0; i < TILE / 8; ++i) {
      const int r = rg + 8 * i, t = t0 + r;
      float dz[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < T) {
        const float4 dm = *reinterpret_cast<const float4*>(du_b + (size_t)t * H + col);
        float4 dr = make_float4(0.f, 0.f, 0.f, 0.f), dl = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t + d < T) dr = *reinterpret_cast<const float4*>(du_b + (size_t)(t + d) * H + col);
        if (t - d >= 0) dl = *reinterpret_cast<const float4*>(du_b + (size_t)(t - d) * H + col);
        const float4 zt = *reinterpret_cast<const float4*>(z_b + (size_t)t * H + col);
        const float dmv[4] = {dm.x, dm.y, dm.z, dm.w}, drv[4] = {dr.x, dr.y, dr.z, dr.w};
        const float dlv[4] = {dl.x, dl.y, dl.z, dl.w}, zv[4] = {zt.x, zt.y, zt.z, zt.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float dh = drv[k] * c0[k] + (dmv[k] * c1[k] + dlv[k] * c2[k]);
          dh += al1 + be1 * prelu(zv[k], a1);
          dz[k] = zv[k] >= 0.f ? dh : a1 * dh;
          da1 += dh * fminf(zv[k], 0.f);
          db1[k] += dz[k];
        }
      }
      const uint2 u = pack4(dz[0], dz[1], dz[2], dz[3]);
      *reinterpret_cast<uint2*>(sA + r * LDA + 4 * cg) = u;
      *reinterpret_cast<uint2*>(dzb + (row0 + r) * H + col) = u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) red[rg * CH + 4 * cg + k] = db1[k];
    __syncthreads();
    mma_tile_bt(acc, sA, sB, CH);
    reduce_warps_store(red, partDb1 + ((size_t)b * n_tiles + tile) * H + ch);
    __syncthreads();
  }
  store_acc(acc, sC, LDC);
  __syncthreads();
  for (int i = 0; i < TILE / 8; ++i) {
    const int r = rg + 8 * i, t = t0 + r;
    if (t >= T) break;
    float4* gp = reinterpret_cast<float4*>(g + (row0 + r) * C + 4 * cg);
    const float4 add = *reinterpret_cast<const float4*>(sC + r * LDC + 4 * cg);
    float4 gv = *gp;
    gv.x += add.x;
    gv.y += add.y;
    gv.z += add.z;
    gv.w += add.w;
    *gp = gv;
  }
  block_sum2_store(da1, 0.f, partDa1 + ((size_t)b * n_tiles + tile) * 2);
}

// mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix, for the
// weight-gradient products.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One weight-gradient product out[M][N] = sum_s scale_s * A_s^T Bm_s over
// the Tpad rows of each sample s: A [rows][M] (row stride lda, sample
// stride a_bs), Bm [rows][N]; scale_s = scale[s * scale_bs], or 1 without
// scale.  Partials [B * spl][M][N] go to part.
struct WgProduct {
  const bf16* A;
  size_t a_bs;
  int lda;
  const bf16* Bm;
  size_t b_bs;
  int ldb;
  int M, N;
  const float* scale;
  int scale_bs;
  float* part;
};

// Split-K weight gradients of two products in one launch (grid: B * spl
// splits, then p0's 128 x 128 output tiles followed by p1's).  A 4-stage
// cp.async ring of 32-row A and Bm tiles feeds mma.sync; warp (wm, wn) of
// the 2 x 4 warps owns a 64 x 32 piece of the tile.  Each split covers a
// whole number of 64-row tiles of one sample, and its partial is scaled
// by that sample's scale as it is stored.
__global__ void __launch_bounds__(THREADS, 2)
wgrad_kernel(WgProduct p0, WgProduct p1, int tiles0, int spl, int chunk, int Tpad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const bool second = (int)blockIdx.y >= tiles0;
  const WgProduct p = second ? p1 : p0;
  const int tile = second ? blockIdx.y - tiles0 : blockIdx.y;
  const int ntn = p.N / WG_T;
  const int m0 = (tile / ntn) * WG_T, n0 = (tile % ntn) * WG_T;
  const int split = blockIdx.x, smp = split / spl, k = split % spl;
  const int r_begin = k * chunk, r_end = min(Tpad, r_begin + chunk);
  const int nk = (r_end - r_begin) / WG_K;
  const bf16* a_s = p.A + smp * p.a_bs + (size_t)r_begin * p.lda + m0;
  const bf16* b_s = p.Bm + smp * p.b_bs + (size_t)r_begin * p.ldb + n0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  auto load_stage = [&](int kt) {
    if (kt < nk) {
      bf16* sa = sm + (kt % WG_STAGES) * WG_STAGE;
      bf16* sb = sa + WG_K * LDW;
      const bf16* ga = a_s + (size_t)kt * WG_K * p.lda;
      const bf16* gb = b_s + (size_t)kt * WG_K * p.ldb;
      for (int i = tid; i < WG_K * (WG_T / 8); i += THREADS) {
        const int r = i / (WG_T / 8), c = (i % (WG_T / 8)) * 8;
        cp_async16(sa + r * LDW + c, ga + (size_t)r * p.lda + c);
        cp_async16(sb + r * LDW + c, gb + (size_t)r * p.ldb + c);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < WG_STAGES - 1; ++kt) load_stage(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // stage kt in place; every read of stage kt - 1 done
    const bf16* sa = sm + (kt % WG_STAGES) * WG_STAGE;
    const bf16* sb = sa + WG_K * LDW;
#pragma unroll
    for (int kk = 0; kk < WG_K; kk += 16) {
      uint32_t af[4][4], bq[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // A fragments from the [k][m] tile, transposed
        ldmatrix_x4_trans(af[i], sa + (kk + (lane & 7) + 8 * (lane >> 4)) * LDW + wm * 64 + i * 16 +
                                     8 * ((lane >> 3) & 1));
#pragma unroll
      for (int j = 0; j < 2; ++j)  // B fragments of two n8 tiles from the [k][n] tile
        ldmatrix_x4_trans(bq[j], sb + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDW + wn * 32 +
                                     j * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], af[i], bq[j >> 1][2 * (j & 1)], bq[j >> 1][2 * (j & 1) + 1]);
    }
    load_stage(kt + WG_STAGES - 1);
  }
  cp_async_wait<0>();

  const float sc = p.scale ? p.scale[(size_t)smp * p.scale_bs] : 1.f;
  float* out = p.part + (size_t)split * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + wm * 64 + i * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + (size_t)m * p.N + n) = make_float2(sc * acc[i][j][0], sc * acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(m + 8) * p.N + n) =
          make_float2(sc * acc[i][j][2], sc * acc[i][j][3]);
    }
  }
}

// The end of a block of the chain, one launch: the first n_red thread
// blocks sum the weight-gradient partials of both products (out_p[i] =
// sum over the nsplit partials of product p, in order; float4 a thread);
// the rest, one per (32-channel chunk, sample), sum db1 from its per-tile
// partials (warp w the tiles i = w mod 8, then the warps in order) into
// that sample's dvecs row, and da1 with the first chunk.
__global__ void __launch_bounds__(THREADS)
block_finish_kernel(const float* __restrict__ wpart, int nsplit, int MN, float* __restrict__ out0,
                    float* __restrict__ out1, int n_red, const float* __restrict__ partDb1,
                    const float* __restrict__ partDa1, float* __restrict__ dvec_s, size_t dvec_bs,
                    int H, int n_tiles) {
  if ((int)blockIdx.x < n_red) {
    const int i4 = blockIdx.x * THREADS + threadIdx.x, per = MN / 4;
    if (i4 >= 2 * per) return;
    const int prod = i4 / per, i = i4 - prod * per;
    const float4* part = reinterpret_cast<const float4*>(wpart + (size_t)prod * nsplit * MN);
    float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nsplit; ++k) {
      const float4 v = part[(size_t)k * per + i];
      tot.x += v.x;
      tot.y += v.y;
      tot.z += v.z;
      tot.w += v.w;
    }
    reinterpret_cast<float4*>(prod ? out1 : out0)[i] = tot;
    return;
  }
  __shared__ float red[NWARPS][32];
  const int j = blockIdx.x - n_red, nchunk = H / 32, chunk = j % nchunk, b = j / nchunk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, c = 32 * chunk + lane;
  float s = 0.f;
  for (int i = w; i < n_tiles; i += NWARPS) s += partDb1[((size_t)b * n_tiles + i) * H + c];
  red[w][lane] = s;
  __syncthreads();
  float* out = dvec_s + b * dvec_bs;
  if (w == 0) {
    s = 0.f;
    for (int k = 0; k < NWARPS; ++k) s += red[k][lane];
    out[V_B1 * H + c] = s;
  } else if (w == 1 && chunk == 0) {
    float da1 = 0.f;
    for (int i = lane; i < n_tiles; i += 32) da1 += partDa1[((size_t)b * n_tiles + i) * 2];
    da1 = warp_sum(da1);
    if (lane == 0) out[7 * H] = da1;
  }
}

// out[i] = sum_s in[s*n + i], samples in order.
__global__ void __launch_bounds__(256)
sum_samples_kernel(const float* __restrict__ in, int B, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += in[(size_t)b * n + i];
  out[i] = s;
}

// Workspace layout (all f32 words unless noted; every part 256-byte aligned).
struct Workspace {
  float *z, *du, *partA, *partSg, *part6, *partDa2, *partDb1, *partDa1, *coef, *coefpart,
      *dvec_s, *dcs_s, *wpart;
  bf16 *vb, *dzb, *gb;
};

size_t align_up(size_t n) { return (n + 63) / 64 * 64; }  // in 4-byte words

// Carve the workspace (or, with base == nullptr, just size it): returns its
// size in bytes.
size_t carve(char* base, int B, int Tpad, int H, int nb, int n_tiles, int spl, Workspace* ws) {
  size_t off = 0;  // in words
  auto take = [&](size_t words) {
    float* p = base ? reinterpret_cast<float*>(base) + off : nullptr;
    off += align_up(words);
    return p;
  };
  const size_t rows = (size_t)B * Tpad;
  ws->z = take(rows * H);
  ws->du = take(rows * H);
  ws->vb = reinterpret_cast<bf16*>(take(rows * H / 2));
  ws->dzb = reinterpret_cast<bf16*>(take(rows * H / 2));
  ws->gb = reinterpret_cast<bf16*>(take(rows * C / 2));
  ws->partA = take((size_t)B * n_tiles * 2);
  ws->partSg = take((size_t)B * n_tiles * C);
  ws->part6 = take((size_t)B * n_tiles * NQ * H);
  ws->partDa2 = take((size_t)B * n_tiles * 2);
  ws->partDb1 = take((size_t)B * n_tiles * H);
  ws->partDa1 = take((size_t)B * n_tiles * 2);
  ws->coef = take((size_t)B * 4);
  ws->coefpart = take((size_t)B * (H / 32) * 2);
  ws->dvec_s = take((size_t)B * nb * 8 * H);
  ws->dcs_s = take((size_t)B * nb * 2 * C);
  ws->wpart = take((size_t)2 * B * spl * C * H);
  return off * 4;
}

// Splits per sample of the weight-gradient products: at most two thread
// blocks an SM on 132 SMs for both products' 2 * (H/128) output tiles, each
// split a whole number of 64-row tiles.
void splits(int B, int H, int n_tiles, int* spl, int* chunk) {
  const int tiles = 2 * (H / WG_T);
  int want = (2 * 132) / (tiles * B);
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  const int per = (n_tiles + want - 1) / want;
  *spl = (n_tiles + per - 1) / per;
  *chunk = per * TILE;
}

constexpr int LAUNCHES_PER_BLOCK = 7;  // see the loop in tcn_backward

}  // namespace

// Launches of one tcn_backward call over nb blocks (the wrappers count with
// this).
extern "C" int tcn_backward_launches(int nb) { return LAUNCHES_PER_BLOCK * nb + 2; }

extern "C" size_t tcn_backward_workspace_bytes(int B, int T, int H, int nb) {
  const int n_tiles = (T + TILE - 1) / TILE;
  int spl, chunk;
  splits(B, H, n_tiles, &spl, &chunk);
  Workspace ws;
  return carve(nullptr, B, n_tiles * TILE, H, nb, n_tiles, spl, &ws);
}

// The chain's backward on ``stream``: tcn_backward_launches(nb) launches.
// g [B, Tpad, 128] f32 holds the cotangent of the chain output (rows >= T
// zero) and is updated in place, block by block, into the cotangent of the
// chain input (the caller takes dx from it).  y_hist [B, nb, Tpad, 128]
// bf16 and stats [B, nb, 4] f32 are the forward's saved state, y_fin [B, T,
// 128] bf16 its output.  Outputs (f32): dw1s [nb, 128, H], dwsgs [nb, H,
// 128], dvecs [nb, 8, H] (row 7 holds da1, da2 in lanes 0 and 1, zeros
// elsewhere), dcs [nb, 2, 128].  ``ws`` is tcn_backward_workspace_bytes(B,
// T, H, nb) bytes.  Returns a cudaError_t.
extern "C" int tcn_backward(void* g, const void* y_hist, const void* y_fin, const void* stats,
                            const void* w1s, const void* wsgs, const void* vecs, const void* cs,
                            const void* alphas, void* dw1s, void* dwsgs, void* dvecs, void* dcs,
                            void* ws_ptr, int B, int T, int H, int nb, const int* dils,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (T + TILE - 1) / TILE, Tpad = n_tiles * TILE;
  int spl, chunk;
  splits(B, H, n_tiles, &spl, &chunk);
  Workspace ws;
  carve(static_cast<char*>(ws_ptr), B, Tpad, H, nb, n_tiles, spl, &ws);
  RETURN_IF_ERROR(cudaFuncSetAttribute(bwd_p1_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BP1));
  RETURN_IF_ERROR(cudaFuncSetAttribute(bwd_p2_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BP2));
  RETURN_IF_ERROR(cudaFuncSetAttribute(bwd_p3_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BP3));
  RETURN_IF_ERROR(cudaFuncSetAttribute(wgrad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_WG));
  const size_t dvec_words = (size_t)B * nb * 8 * H;
  RETURN_IF_ERROR(cudaMemsetAsync(ws.dvec_s, 0, dvec_words * 4, stream));

  float* g_ = static_cast<float*>(g);
  const bf16* yh = static_cast<const bf16*>(y_hist);
  const float* st = static_cast<const float*>(stats);
  const bf16* w1s_ = static_cast<const bf16*>(w1s);
  const bf16* wsgs_ = static_cast<const bf16*>(wsgs);
  const float* vecs_ = static_cast<const float*>(vecs);
  const float* cs_ = static_cast<const float*>(cs);
  const float* alphas_ = static_cast<const float*>(alphas);
  const dim3 grid(n_tiles, B);
  const size_t slot = (size_t)Tpad * C, hbs = (size_t)nb * slot, wide_bs = (size_t)Tpad * H;
  const int st_bs = 4 * nb;
  const int tiles_p = (H / WG_T) * (C / WG_T);
  const int nsplit = B * spl, n_red = (2 * C * H / 4 + THREADS - 1) / THREADS;

  for (int b = nb - 1; b >= 0; --b) {
    const bf16* y_cur = yh + b * slot;
    const bf16* y_next = b == nb - 1 ? static_cast<const bf16*>(y_fin) : yh + (b + 1) * slot;
    const size_t ynext_bs = b == nb - 1 ? (size_t)T * C : hbs;
    const float* st_b = st + 4 * b;
    const float* cs_b = cs_ + (size_t)b * 2 * C;
    const float* vec_b = vecs_ + (size_t)b * 8 * H;
    const float* alpha_b = alphas_ + 2 * b;
    const bf16* w1_b = w1s_ + (size_t)b * C * H;
    float* dvec_b = ws.dvec_s + (size_t)b * 8 * H;
    const size_t dvec_bs = (size_t)nb * 8 * H;

    bwd_p1_kernel<<<grid, THREADS, SMEM_BP1, stream>>>(
        g_, y_cur, hbs, y_next, ynext_bs, st_b, st_bs, cs_b, w1_b, vec_b, ws.z, ws.gb, ws.partA,
        ws.partSg, T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    stats2_finish_kernel<<<B, 8 * C, 0, stream>>>(ws.partA, ws.partSg, st_b, st_bs, cs_b, ws.coef,
                                                  ws.dcs_s + (size_t)b * 2 * C, (size_t)nb * 2 * C,
                                                  T, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    bwd_p2_kernel<<<grid, THREADS, SMEM_BP2, stream>>>(
        ws.z, ws.gb, st_b, st_bs, vec_b, alpha_b, wsgs_ + (size_t)b * H * C, ws.coef, ws.du,
        ws.vb, ws.part6, ws.partDa2, dils[b], T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    stats1_finish_kernel<<<dim3(H / 32, B), THREADS, 0, stream>>>(
        ws.part6, ws.partDa2, st_b, st_bs, vec_b, ws.coefpart, dvec_b, dvec_bs, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    bwd_p3_kernel<<<grid, THREADS, SMEM_BP3, stream>>>(
        ws.du, ws.z, st_b, st_bs, vec_b, alpha_b, w1_b, ws.coefpart, g_, ws.dzb, ws.partDb1,
        ws.partDa1, dils[b], T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    // dWsg = sum_s r2_s v_s^T g_s ([H, 128]) and dW1 = sum_s y_s^T dz_s ([128, H])
    const WgProduct p_sg{ws.vb, wide_bs, H, ws.gb, slot, C, H, C, st_b + 3, st_bs, ws.wpart};
    const WgProduct p_w1{y_cur, hbs, C, ws.dzb, wide_bs, H, C, H, nullptr, 0,
                         ws.wpart + (size_t)nsplit * C * H};
    wgrad_kernel<<<dim3(nsplit, 2 * tiles_p), THREADS, SMEM_WG, stream>>>(p_sg, p_w1, tiles_p, spl,
                                                                           chunk, Tpad);
    RETURN_IF_ERROR(cudaGetLastError());
    block_finish_kernel<<<n_red + (H / 32) * B, THREADS, 0, stream>>>(
        ws.wpart, nsplit, C * H, static_cast<float*>(dwsgs) + (size_t)b * H * C,
        static_cast<float*>(dw1s) + (size_t)b * C * H, n_red, ws.partDb1, ws.partDa1, dvec_b,
        dvec_bs, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  sum_samples_kernel<<<(nb * 8 * H + 255) / 256, 256, 0, stream>>>(ws.dvec_s, B, nb * 8 * H,
                                                                   static_cast<float*>(dvecs));
  RETURN_IF_ERROR(cudaGetLastError());
  sum_samples_kernel<<<(nb * 2 * C + 255) / 256, 256, 0, stream>>>(ws.dcs_s, B, nb * 2 * C,
                                                                   static_cast<float*>(dcs));
  RETURN_IF_ERROR(cudaGetLastError());
  return 0;
}
