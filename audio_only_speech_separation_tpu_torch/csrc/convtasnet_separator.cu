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
// update.  Each is a kernel boundary.  h does not cross them:
// block_p1_kernel (P1) computes h only for its statistics, and
// block_p2_kernel (P2) recomputes the h it needs from the block's bf16
// input y (256 B a frame where h is 2 KB).  A block moves y and the
// pending product P through device memory: P1 reads y and P and writes y,
// P2 reads y (its halo mostly from L2) and writes P, 1792 B a padded frame.
// The taps need h at t - d, t and t + d, and P2 recomputes all three
// windows, so a block does five [64 x 128] x [128 x 64] products a
// 64-frame tile and 64-channel sub-chunk where the function needs two.
// Neither the bytes nor the products are what the kernels wait on: the
// products run on wgmma and overlap the rest; P2 is bound by its
// epilogues on the accumulators of three windows (bias, PReLU, gLN-1, the
// taps, then v and its statistics) and the latency between them, at two
// warpgroups an SM, and by streaming its weights; P1 by the device-memory
// traffic of its pending update.  PERF.md has the measured breakdown.
//
// What the design does about it.
// - h is recomputed, never stored (above); rows outside [0, T') get a zero
//   tap weight, and only rows < T' enter the statistics.
// - Products are wgmma (m64nNk16, bf16 in, f32 sums in registers): a
//   warpgroup owns a 64-frame tile, exactly an m64 product.  Operands lie
//   in shared memory in the no-swizzle core layout; W1^T and wsg^T are
//   handed to the kernels already in that layout, a 64-channel sub-chunk
//   contiguous, so one thread stages a sub-chunk with one bulk copy.
// - P1 is persistent and keeps all of W1^T resident in shared memory; its
//   four warpgroups each walk their own run of tiles, so one's pending
//   update overlaps another's products.
// - P2 is persistent: two warpgroups (two tiles) share every weight
//   sub-chunk, streamed through a 3-stage ring of bulk copies and
//   mbarriers.  Each window's epilogue runs while the tensor cores form
//   the next window, v is the register A operand of v @ wsg, and that
//   product runs while the next sub-chunk's windows are formed.  The next
//   tile pair's windows load during the last sub-chunk.
// - Epilogues are branch-free (rows are masked by selects), so the
//   unrolled loops keep their instruction-level parallelism.
//
// Structure: the C entry point convtasnet_separator launches, on the
// caller's stream,
//   encoder_kernel                  enc = frames @ we (bf16), P = enc @ wsg0,
//                                   stats of enc
//   per block: block_p1_kernel      y += pending update; h = PReLU(y@W1+b1)
//                                   in registers; stats of h
//              block_p2_kernel      h recomputed from y at t - d, t, t + d;
//                                   u = depthwise taps of gLN-1(h), zeros
//                                   outside [0, T'); v = PReLU(u); stats of v;
//                                   P = v @ wsg
//   head_kernel                     last update; mask; * enc; @ wd
// = convtasnet_separator_launches(nb) = 2 + 2*nb launches.  Statistics are
// per-tile (sum, sum of squares) partials in a [B, n_tiles, 2] buffer that
// the next kernel sums in a fixed order: no atomics, so a run repeats bit
// for bit.  The encoder and head keep bf16 WMMA fragments on staged tiles
// (a small share of a call), a thread block a 64-frame tile.
//
// The same block body also serves the TCN chain of training (entry
// tcn_separator), which replaces the TPU kernel entered through
// ops/pallas/convtasnet_block.py::fused_tcn_separator(save_state=True): x
// [B, T', 128] -> y, plus each block's input y_b in y_hist and each
// block's gLN statistics, which the backward (convtasnet_backward.cu)
// recomputes from.  There P1 reads y_{b-1} from one y_hist slot and
// writes y_b to the next, P2 recomputes h from that slot, and the thread
// block that owns tile 0 of a sample records the statistics it has just
// finished.

#include "convtasnet_common.cuh"

namespace {

constexpr int LDWD = WIN + 8;  // bf16 row stride of a decoder chunk
constexpr int LDD = WIN + 4;   // f32 row stride of the decoder product
constexpr int WD_BYTES = CH * LDWD * 2;     // [128][LDWD] bf16
constexpr int D_BYTES = TILE * LDD * 4;     // [TILE][LDD] f32

constexpr int WG = 128;    // threads of a warpgroup, which owns one 64-frame tile
constexpr int SUB = 64;    // hidden channels per product: n of y @ W1, k of v @ wsg
constexpr int P1_WGS = 4;  // warpgroups of a block_p1_kernel thread block
constexpr int P2_WGS = 2;  // warpgroups of a block_p2_kernel thread block
constexpr int NS = 3;      // stages of block_p2_kernel's weight ring

constexpr int SMEM_ENC = 2 * A_BYTES + B_BYTES + C_BYTES;
// block_p1_kernel: all of W1^T and a y tile a warpgroup (196,608 bytes at
// H = 512; the block body takes H <= 640)
int smem_p1(int H) { return (H + P1_WGS * TILE) * C * 2; }
// block_p2_kernel: NS stages of W1^T, wsg^T and vec rows 0-6, three y
// windows a warpgroup (201,984 bytes)
constexpr int SMEM_P2 = NS * (2 * SUB * C * 2 + 7 * SUB * 4) + P2_WGS * 3 * TILE * C * 2;
constexpr int SMEM_HEAD = 2 * A_BYTES + B_BYTES + C_BYTES + WD_BYTES + D_BYTES;
constexpr int LAUNCHES_PER_BLOCK = 2;  // block_p1_kernel, block_p2_kernel

// Element offset of (r, k) in a [rows][K] tile in the block body's core
// layout (see the wgmma section below).
__device__ __forceinline__ int core_index(int r, int k, int K) {
  return ((r >> 3) * (K >> 3) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}

// How block_p1_kernel forms a block's input y from the previous one.
constexpr int UPD_ADD = 0;    // y_old + r2 * P + shift (a TCN block's residual)
constexpr int UPD_FIRST = 1;  // r2 * P + shift (the bottleneck's output is the first y)
constexpr int UPD_COPY = 2;   // y_old as it is (the chain's input x)

// y = y_old + r2 * P + (c0 - mean2 * r2 * c1) for the tile's rows, rounded
// to bf16, into sA (and into y_out when it is set); rows >= T are zero.
// ``mode`` is UPD_ADD, UPD_FIRST (no y_old) or UPD_COPY (y = y_old; P, cs
// and the statistics are not read).  NT threads, tid = 0 .. NT-1; sA has
// row stride LDA, or with CORE the block body's core layout.  Each thread
// issues the loads of eight rows before it uses them.
template <int NT, bool CORE>
__device__ __forceinline__ void pending_update(const bf16* y_old, bf16* y_out, const float* P,
                                               const float* cs, float mean2, float r2, int mode,
                                               int t0, int T, bf16* sA, int tid) {
  constexpr int RP = NT / 32, BATCH = 8;  // rows a pass; passes whose loads go out together
  const int cg = tid & 31, rg = tid >> 5;
  float sh[4] = {0.f, 0.f, 0.f, 0.f};
  if (mode != UPD_COPY) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sh[k] = cs[4 * cg + k] - mean2 * r2 * cs[C + 4 * cg + k];
  }
  for (int i0 = 0; i0 < TILE / RP; i0 += BATCH) {
    float4 yv[BATCH], pv[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = rg + RP * (i0 + i);
      const size_t off = (size_t)r * C + 4 * cg;
      yv[i] = pv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + r < T) {
        if (mode != UPD_FIRST) yv[i] = unpack4(*reinterpret_cast<const uint2*>(y_old + off));
        if (mode != UPD_COPY) pv[i] = *reinterpret_cast<const float4*>(P + off);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = rg + RP * (i0 + i);
      float4 v = yv[i];
      if (mode != UPD_COPY && t0 + r < T) {
        v.x = v.x + r2 * pv[i].x + sh[0];
        v.y = v.y + r2 * pv[i].y + sh[1];
        v.z = v.z + r2 * pv[i].z + sh[2];
        v.w = v.w + r2 * pv[i].w + sh[3];
      }
      const uint2 u = pack4(v.x, v.y, v.z, v.w);
      *reinterpret_cast<uint2*>(sA + (CORE ? core_index(r, 4 * cg, C) : r * LDA + 4 * cg)) = u;
      if (y_out) *reinterpret_cast<uint2*>(y_out + (size_t)r * C + 4 * cg) = u;
    }
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

// ---- The block body's products: wgmma (warpgroup MMA) ----------------
// A thread block of the block body is one warpgroup (WG = 128 threads)
// and owns TILE = 64 frames: exactly the rows of one m64 wgmma.  Operands
// lie in shared memory in the no-swizzle K-major layout: a [rows][K] bf16
// tile is cut into 8 x 8 core matrices (8 rows of 16 bytes, 128 contiguous
// bytes), K fastest, so core (r/8, k/8) starts at byte ((r/8) K/8 + k/8)
// * 128.  A thread's accumulator element 4j + e of an m64nN product is row
// 16 * warp + lane/4 + 8 (e/2), column 8j + 2 (lane%4) + e%2.

// Descriptor of a [rows][K] core-layout tile: LBO 128 B (the next core
// matrix along K), SBO K/8 * 128 B (the next 8 rows), no swizzle.  A k16
// step further along K is +16 (256 B >> 4).
__device__ __forceinline__ uint64_t wg_desc(const bf16* tile, int K) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((K / 8 * 128) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// This thread's shared-memory writes, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pin accumulator registers in program order around an asynchronous
// wgmma, so that no read of them moves before its wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A @ B^T, m64n64k16: A and B from shared memory (descriptors);
// d accumulates when ``acc`` is nonzero, else is overwritten.
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A @ B^T, m64n128k16: A from registers (the m16k16 fragment of
// each warp's 16 rows), B from shared memory (descriptor).
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// mbarriers and bulk copies (TMA without a tensor map): one thread copies
// a contiguous block of global memory into shared memory, and the copy
// completes a transaction count on an mbarrier that consumers wait on.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity ``parity`` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// acc = A @ W1 for SUB hidden channels: A the [TILE][128] y tile at sA, W
// the [SUB][128] sub-chunk of W1^T at sW (both core layout); 8 k16 steps
// in order, issued but not waited for.  P1 and P2 both form h with this
// one routine, so P2's recomputed h is P1's bit for bit.
__device__ __forceinline__ void h_product(float (&acc)[32], const bf16* sA, const bf16* sW) {
  const uint64_t da = wg_desc(sA, C), db = wg_desc(sW, C);
#pragma unroll
  for (int s = 0; s < C / 16; ++s) wgmma_n64_ss(acc, da + 16 * s, db + 16 * s, s);
}

// The barrier of warpgroup wg alone (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
}

// finish_stats for one warpgroup: its first warp sums the partials, in
// order, into ms; the warpgroup then syncs.
__device__ __forceinline__ void wg_finish_stats(const float* part, int n_tiles, float inv_count,
                                                float* ms, int wg) {
  const int t = threadIdx.x & (WG - 1);
  if (t < 32) {
    float s = 0.f, q = 0.f;
    for (int i = t; i < n_tiles; i += 32) {
      s += part[2 * i];
      q += part[2 * i + 1];
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (t == 0) {
      const float mean = s * inv_count;
      ms[0] = mean;
      ms[1] = 1.f / sqrtf(fmaxf(q * inv_count - mean * mean, 0.f) + EPS);
    }
  }
  wg_sync(wg);
}

// block_sum2_store for one warpgroup, its four warps summed in order
// through red[8]; thread 0 of the warpgroup writes out[0..1].
__device__ __forceinline__ void wg_sum2_store(float s, float q, float* out, float* red, int wg) {
  s = warp_sum(s);
  q = warp_sum(q);
  const int t = threadIdx.x & (WG - 1), w = t >> 5;
  if ((t & 31) == 0) {
    red[w] = s;
    red[4 + w] = q;
  }
  wg_sync(wg);
  if (t == 0 && out) {
    float ts = 0.f, tq = 0.f;
    for (int i = 0; i < 4; ++i) {
      ts += red[i];
      tq += red[4 + i];
    }
    out[0] = ts;
    out[1] = tq;
  }
}

// The statistics of h on one finished product: b1, PReLU, rows < T.
// Branch-free (rows past T add zeros), so the unrolled loop keeps its
// instruction-level parallelism.
__device__ __forceinline__ void h_stats(const float (&acc)[32], const float* b1, float a1, int r0,
                                        int T, int cq, float& s, float& q) {
  const bool ok0 = r0 < T, ok1 = r0 + 8 < T;
#pragma unroll
  for (int j = 0; j < SUB / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * j + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = prelu(acc[4 * j + e] + ((e & 1) ? bb.y : bb.x), a1);
      const float hm = ((e >> 1) ? ok1 : ok0) ? h : 0.f;
      s += hm;
      q += hm * hm;
    }
  }
}

// Pending residual update of the previous block (``mode``), then
// h = PReLU(y @ W1 + b1) for a tile's rows, of which only the per-tile
// statistics (rows < T) are kept: h never leaves the registers.  The
// block's input y is read from y_in and written to y_out (the same buffer
// in the separator; successive y_hist slots in the TCN chain), each with
// its own per-sample stride; block_p2_kernel recomputes h from it.
// Persistent: W1^T (w1c, in the core layout, a SUB-channel sub-chunk
// contiguous) is loaded once into shared memory with bulk copies and
// stays there, and each of the P1_WGS warpgroups walks its own run of
// (sample, tile) jobs, so one's update overlaps another's products.  When
// ``st_prev`` is set, tile 0 writes the previous block's (mean2, rstd2)
// there (per-sample stride st_bs).
__global__ void __launch_bounds__(P1_WGS * WG)
block_p1_kernel(const bf16* y_in, size_t y_in_bs, bf16* y_out, size_t y_out_bs,
                const float* __restrict__ P, const float* __restrict__ part_in,
                float* __restrict__ part_out, const float* __restrict__ cs_prev,
                const bf16* __restrict__ w1c, const float* __restrict__ vec,
                const float* __restrict__ alpha, float* __restrict__ st_prev, int st_bs, int mode,
                int B, int T, int Tpad, int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ms[P1_WGS][2], red[P1_WGS][8];
  __shared__ uint64_t loaded;
  const int wg = threadIdx.x / WG, t = threadIdx.x & (WG - 1), nsub = H / SUB;
  bf16* sW = reinterpret_cast<bf16*>(smem);    // W1^T [H][C]: nsub sub-chunks of [SUB][C]
  bf16* sA = sW + H * C + wg * TILE * C;       // this warpgroup's y tile [TILE][C]
  if (threadIdx.x == 0) {
    mbar_init(&loaded, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&loaded, H * C * 2);
    for (int c = 0; c < nsub; ++c)
      bulk_copy(sW + c * SUB * C, w1c + (size_t)c * SUB * C, SUB * C * 2, &loaded);
  }
  __syncthreads();
  mbar_wait(&loaded, 0);

  const int lane = t & 31, rw = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
  const float a1 = alpha[0], inv_count = 1.f / ((float)T * (float)H);
  float accA[32], accB[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) accA[i] = accB[i] = 0.f;
  // warpgroup w of the grid takes the jobs [w J / W, (w + 1) J / W) of the
  // J = B * n_tiles (sample, tile) jobs in order, so it finishes a
  // sample's statistics once for its run of that sample's tiles
  const int workers = gridDim.x * P1_WGS, worker = blockIdx.x * P1_WGS + wg, jobs = B * n_tiles;
  const int job_end = (int)((long long)(worker + 1) * jobs / workers);
  for (int job = (int)((long long)worker * jobs / workers), b_ms = -1; job < job_end; ++job) {
    const int b = job / n_tiles, tile = job - b * n_tiles, t0 = tile * TILE;
    if (mode != UPD_COPY && b != b_ms) {
      b_ms = b;
      wg_finish_stats(part_in + (size_t)b * n_tiles * 2, n_tiles, inv_count, ms[wg], wg);
    }
    if (mode != UPD_COPY) {
      if (st_prev && tile == 0 && t == 0) {
        st_prev[(size_t)b * st_bs] = ms[wg][0];
        st_prev[(size_t)b * st_bs + 1] = ms[wg][1];
      }
    }
    const size_t row0 = (size_t)b * Tpad + t0;
    pending_update<WG, true>(y_in + b * y_in_bs + (size_t)t0 * C,
                             y_out + b * y_out_bs + (size_t)t0 * C, P + row0 * C, cs_prev,
                             ms[wg][0], ms[wg][1], mode, t0, T, sA, t);
    fence_async_smem();
    wg_sync(wg);  // the y tile is in place

    // each product's statistics are taken while the next one runs
    float s = 0.f, q = 0.f;
    pin(accA);
    wg_fence();
    h_product(accA, sA, sW);
    wg_commit();
    for (int c = 0; c < nsub; c += 2) {  // nsub is even: H % 128 == 0
      pin(accB);
      wg_fence();
      h_product(accB, sA, sW + (c + 1) * SUB * C);
      wg_commit();
      wg_wait<1>();
      pin(accA);
      h_stats(accA, vec + V_B1 * H + c * SUB, a1, t0 + rw, T, cq, s, q);
      if (c + 2 < nsub) {
        pin(accA);
        wg_fence();
        h_product(accA, sA, sW + (c + 2) * SUB * C);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      pin(accB);
      h_stats(accB, vec + V_B1 * H + (c + 1) * SUB, a1, t0 + rw, T, cq, s, q);
    }
    // the warpgroup's barrier inside also frees sA: every wgmma reading it has been waited for
    wg_sum2_store(s, q, part_out + ((size_t)b * n_tiles + tile) * 2, red[wg], wg);
  }
}

// u = dwb + sum_k dw_k * gLN1(h)[t + (k-1)d] (zero outside [0, T)),
// v = PReLU(u), statistics of v, P = bf16(v) @ wsg (f32), with h
// recomputed from the block's input y (bf16, from block_p1_kernel), never
// read.  Persistent: a thread block of P2_WGS warpgroups walks its run of
// tile pairs (each warpgroup a tile of one sample) and streams the weight
// sub-chunks both warpgroups share -- W1^T, wsg^T (w1c, wsgc: in the core
// layout, a sub-chunk contiguous) and the block's vec rows, SUB channels
// at a time -- through an NS-stage ring of bulk copies and mbarriers that
// cycles over the sub-chunks across pairs.  A warpgroup's window k = 0,
// 1, 2 holds the y rows t0 + (k-1)d .. +TILE (zeros outside [0, T)); per
// sub-chunk the three windows are multiplied by the same W1^T sub-chunk,
// so each thread holds h at t - d, t and t + d at the same (row, channel)
// (P1's h bit for bit: same product routine and order, same bias and
// PReLU) and does the taps there, on one window's accumulators while the
// tensor cores form the next.  v stays in registers as the A operand of
// v @ wsg, whose sum stays in registers and runs while the next
// sub-chunk's windows are formed.  The next pair's windows load while the
// last sub-chunk's taps run, and its P stores overlap the next pair.  When
// ``st_cur`` is set, tile 0 writes this block's (mean1, rstd1) there.
__global__ void __launch_bounds__(P2_WGS * WG)
block_p2_kernel(const bf16* __restrict__ y, size_t y_bs, const float* __restrict__ part_in,
                float* __restrict__ part_out, const bf16* __restrict__ w1c,
                const float* __restrict__ vec, const float* __restrict__ alpha,
                const bf16* __restrict__ wsgc, float* __restrict__ P, float* __restrict__ st_cur,
                int st_bs, int d, int B, int T, int Tpad, int H, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ms[2], red[P2_WGS][8];
  __shared__ uint64_t full[NS];  // stage s holds its step's weights
  const int wg = threadIdx.x / WG, t = threadIdx.x & (WG - 1), nsub = H / SUB;
  bf16* sW = reinterpret_cast<bf16*>(smem);                      // NS stages of [SUB][C]
  bf16* sS = sW + NS * SUB * C;                                  // NS stages of [C][SUB]
  float* sV = reinterpret_cast<float*>(sS + NS * C * SUB);       // NS stages of [7][SUB]
  bf16* sY = reinterpret_cast<bf16*>(sV + NS * 7 * SUB) + wg * 3 * TILE * C;  // [3][TILE][C]
  // this thread block's run of tile pairs, in (sample, pair) order
  const int pps = (n_tiles + P2_WGS - 1) / P2_WGS, npairs = B * pps;
  const int pair0 = (int)((long long)blockIdx.x * npairs / gridDim.x);
  const int steps = ((int)((long long)(blockIdx.x + 1) * npairs / gridDim.x) - pair0) * nsub;

  // this warpgroup's three windows of ``pair``, with cp.async: eight
  // consecutive threads fill one core matrix (no bank conflicts)
  auto windows = [&](int pair) {
    const int bw = pair / pps, tw0 = ((pair - bw * pps) * P2_WGS + wg) * TILE;
    const bf16* ysrc = y + bw * y_bs;
    for (int i = t; i < 3 * TILE * (C / 8); i += WG) {
      const int kc = (i >> 3) & 15, k = i >> 10, r = ((i >> 7) & 7) * 8 + (i & 7);
      const int tt = tw0 + (k - 1) * d + r;
      const bool ok = tt >= 0 && tt < T;
      cp_async16_zfill(sY + k * TILE * C + core_index(r, 8 * kc, C),
                       ysrc + (size_t)(ok ? tt : 0) * C + 8 * kc, ok);
    }
  };
  // step g's W1^T, wsg^T and vec rows 0-6 sub-chunk into stage g % NS:
  // bulk copies by one thread, completing on full[g % NS]
  auto stage = [&](int g) {
    if (threadIdx.x == 0 && g < steps) {
      const int c = g % nsub, st = g % NS;
      mbar_expect_tx(&full[st], 2 * SUB * C * 2 + 7 * SUB * 4);
      bulk_copy(sW + st * SUB * C, w1c + (size_t)c * SUB * C, SUB * C * 2, &full[st]);
      bulk_copy(sS + st * C * SUB, wsgc + (size_t)c * C * SUB, C * SUB * 2, &full[st]);
      for (int row = 0; row < 7; ++row)
        bulk_copy(sV + (st * 7 + row) * SUB, vec + (size_t)row * H + c * SUB, SUB * 4, &full[st]);
    }
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  windows(pair0);
  cp_async_commit();
  for (int g = 0; g < NS - 1; ++g) stage(g);

  const int lane = t & 31, rl = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
  const float a1 = alpha[0], a2 = alpha[1], inv_count = 1.f / ((float)T * (float)H);
  float pacc[64], u[32], accA[32], accB[32];
  uint32_t af[SUB / 16][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) pacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) accA[i] = accB[i] = 0.f;
#pragma unroll
  for (int i = 0; i < SUB / 16; ++i) af[i][0] = af[i][1] = af[i][2] = af[i][3] = 0u;
  float s = 0.f, q = 0.f, mean1 = 0.f, r1 = 0.f;
  int b = -1, r0 = 0, tile = 0;

  // u += dw_k * gLN1(h) for window k's rows inside [0, T).  Branch-free:
  // a row outside reads a zero tap weight (its h, from zero input, is
  // finite), so the unrolled loop keeps its instruction-level parallelism.
  auto taps = [&](const float(&acc)[32], int k, const float* kv) {
    const int tw = (k - 1) * d;
    const bool ok0 = r0 + tw >= 0 && r0 + tw < T, ok1 = r0 + 8 + tw >= 0 && r0 + 8 + tw < T;
#pragma unroll
    for (int j = 0; j < SUB / 8; ++j) {
      const int cl = 8 * j + cq;
      const float2 b1 = *reinterpret_cast<const float2*>(kv + V_B1 * SUB + cl);
      const float2 g1 = *reinterpret_cast<const float2*>(kv + V_G1 * SUB + cl);
      const float2 bt = *reinterpret_cast<const float2*>(kv + V_BT1 * SUB + cl);
      const float2 w = *reinterpret_cast<const float2*>(kv + (V_DW0 + k) * SUB + cl);
      const float sc[2] = {g1.x * r1, g1.y * r1};
      const float sh[2] = {bt.x - mean1 * sc[0], bt.y - mean1 * sc[1]};
      const float wk[4] = {ok0 ? w.x : 0.f, ok0 ? w.y : 0.f, ok1 ? w.x : 0.f, ok1 ? w.y : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float h = prelu(acc[4 * j + e] + (odd ? b1.y : b1.x), a1);
        u[4 * j + e] += wk[e] * (h * sc[e & 1] + sh[e & 1]);
      }
    }
  };
  auto pin_af = [&]() {
#pragma unroll
    for (int i = 0; i < SUB / 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(af[i][e])::"memory");
  };

  for (int g = 0; g < steps; ++g) {
    const int c = g % nsub, pair = pair0 + g / nsub;
    if (c == 0) {  // a new pair: its windows landed
      cp_async_wait<0>();
      const int bp = pair / pps;
      tile = (pair - bp * pps) * P2_WGS + wg;
      r0 = tile * TILE + rl;
      if (bp != b) {  // a new sample (uniform: both warpgroups share the pair)
        b = bp;
        finish_stats(part_in + (size_t)b * n_tiles * 2, n_tiles, inv_count, ms);
        mean1 = ms[0];
        r1 = ms[1];
      }
      if (st_cur && tile == 0 && t == 0) {
        st_cur[(size_t)b * st_bs] = mean1;
        st_cur[(size_t)b * st_bs + 1] = r1;
      }
      fence_async_smem();
      __syncthreads();  // every warpgroup's windows in place
    }
    mbar_wait(&full[g % NS], (g / NS) & 1);  // step g's sub-chunk in place
    const bf16* w = sW + (g % NS) * SUB * C;
    pin(accA);
    pin(accB);
    wg_fence();
    h_product(accA, sY, w);
    wg_commit();
    h_product(accB, sY + TILE * C, w);
    wg_commit();
    wg_wait<1>();  // window 0 and the previous step's v @ wsg done
    pin(accA);
    pin(pacc);
    pin_af();
    __syncthreads();  // both warpgroups are done with stage (g - 1) % NS: refill it
    stage(g + NS - 1);
    const float* kv = sV + (g % NS) * 7 * SUB;
#pragma unroll
    for (int j = 0; j < SUB / 8; ++j) {
      const float2 wb = *reinterpret_cast<const float2*>(kv + V_DWB * SUB + 8 * j + cq);
      u[4 * j] = u[4 * j + 2] = wb.x;
      u[4 * j + 1] = u[4 * j + 3] = wb.y;
    }
    // the taps at t - d, t, t + d in that order
    taps(accA, 0, kv);
    pin(accA);
    wg_fence();
    h_product(accA, sY + 2 * TILE * C, w);
    wg_commit();
    wg_wait<1>();
    pin(accB);
    taps(accB, 1, kv);
    wg_wait<0>();
    pin(accA);
    if (c == nsub - 1 && g + 1 < steps) {  // this warpgroup's windows are free: load the next pair's
      windows(pair + 1);
      cp_async_commit();
    }
    taps(accA, 2, kv);

    // v = PReLU(u) for rows < T (zero beyond), its statistics, and its
    // bf16 A fragments for v @ wsg: k16 step st is n8 blocks 2st, 2st + 1
    const bool ok0 = r0 < T, ok1 = r0 + 8 < T;
#pragma unroll
    for (int j = 0; j < SUB / 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = ((e >> 1) ? ok1 : ok0) ? prelu(u[4 * j + e], a2) : 0.f;
        s += v[e];
        q += v[e] * v[e];
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
      af[j >> 1][2 * (j & 1)] = *reinterpret_cast<uint32_t*>(&lo);
      af[j >> 1][2 * (j & 1) + 1] = *reinterpret_cast<uint32_t*>(&hi);
    }
    const uint64_t ds = wg_desc(sS + (g % NS) * C * SUB, SUB);
    pin(pacc);
    wg_fence();
#pragma unroll
    for (int st = 0; st < SUB / 16; ++st) wgmma_n128_rs(pacc, af[st], ds + 16 * st);
    wg_commit();

    if (c == nsub - 1) {  // the pair is done: its P and statistics out
      wg_wait<0>();
      pin(pacc);
      pin_af();
      const bool live = tile < n_tiles;  // a pair may hold one tile past the end
      if (live) {  // all TILE rows; rows >= T are zero, as v is
        float* Pt = P + ((size_t)b * Tpad + tile * TILE) * C;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          *reinterpret_cast<float2*>(Pt + (size_t)rl * C + 8 * j + cq) = make_float2(pacc[4 * j], pacc[4 * j + 1]);
          *reinterpret_cast<float2*>(Pt + (size_t)(rl + 8) * C + 8 * j + cq) =
              make_float2(pacc[4 * j + 2], pacc[4 * j + 3]);
        }
      }
      wg_sum2_store(s, q, live ? part_out + ((size_t)b * n_tiles + tile) * 2 : nullptr, red[wg], wg);
#pragma unroll
      for (int i = 0; i < 64; ++i) pacc[i] = 0.f;
      s = q = 0.f;
    }
  }
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
  pending_update<THREADS, false>(y + row0 * C, nullptr, P + row0 * C, cs_prev, ms[0], ms[1], mode, t0,
                                 T, sA, threadIdx.x);
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

// The block body's launch set-up: shared-memory limits of both kernels,
// and their persistent grids, one thread block an SM (at most one
// warpgroup a tile, one thread block a tile pair).
cudaError_t body_setup(int B, int n_tiles, int H, int* p1_blocks, int* p2_blocks) {
  cudaError_t err = cudaFuncSetAttribute(block_p1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_p1(H));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(block_p2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_P2);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int jobs = (B * n_tiles + P1_WGS - 1) / P1_WGS;
  const int pairs = B * ((n_tiles + P2_WGS - 1) / P2_WGS);
  *p1_blocks = jobs < sms ? jobs : sms;
  *p2_blocks = pairs < sms ? pairs : sms;
  return err;
}

}  // namespace

extern "C" const char* convtasnet_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches of one convtasnet_separator / tcn_separator call over nb
// blocks (the wrappers count with these).
extern "C" int convtasnet_separator_launches(int nb) { return 2 + LAUNCHES_PER_BLOCK * nb; }
extern "C" int tcn_separator_launches(int nb) { return LAUNCHES_PER_BLOCK * nb + 1; }

// The whole separator on ``stream``: convtasnet_separator_launches(nb)
// kernel launches.  Pointers are device pointers to contiguous tensors
// (see the Python wrapper for shapes); ``dils`` is a host array of nb
// dilations.  The block body takes W1^T and wsg^T in the core layout of
// its wgmma operands, a SUB-channel sub-chunk contiguous (w1c, wsgc, each
// [nb+1] blocks of H * 128 bf16; see the wrapper); the encoder takes
// wsgs[0] [H, 128].  Scratch: enc [B, Tpad, H] bf16, y [B, Tpad, 128] bf16,
// p [B, Tpad, 128] f32, part1/part2 [B, n_tiles, 2] f32, with
// n_tiles = ceil(T / 64) and Tpad = 64 * n_tiles.  Returns a cudaError_t.
extern "C" int convtasnet_separator(const void* frames, const void* we, const void* w1c,
                                    const void* wsgs, const void* wsgc, const void* vecs,
                                    const void* cs, const void* alphas, const void* wm,
                                    const void* bm, const void* wd, void* out, void* enc, void* y,
                                    void* p, void* part1, void* part2, int B, int T, int H, int nb,
                                    const int* dils, int nspk, int sigmoid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (T + TILE - 1) / TILE, Tpad = n_tiles * TILE;
  RETURN_IF_ERROR(cudaFuncSetAttribute(encoder_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ENC));
  int p1_blocks, p2_blocks;
  RETURN_IF_ERROR(body_setup(B, n_tiles, H, &p1_blocks, &p2_blocks));
  RETURN_IF_ERROR(cudaFuncSetAttribute(head_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_HEAD));
  const bf16* w1c_ = static_cast<const bf16*>(w1c);
  const bf16* wsgc_ = static_cast<const bf16*>(wsgc);
  const float* vecs_ = static_cast<const float*>(vecs);
  const float* cs_ = static_cast<const float*>(cs);
  const float* alphas_ = static_cast<const float*>(alphas);
  bf16* y_ = static_cast<bf16*>(y);
  float* p_ = static_cast<float*>(p);
  float* part1_ = static_cast<float*>(part1);
  float* part2_ = static_cast<float*>(part2);
  const dim3 grid(n_tiles, B);

  encoder_kernel<<<grid, THREADS, SMEM_ENC, stream>>>(
      static_cast<const bf16*>(frames), static_cast<const bf16*>(we), static_cast<const bf16*>(wsgs),
      static_cast<bf16*>(enc), p_, part2_, T, Tpad, H, n_tiles);
  RETURN_IF_ERROR(cudaGetLastError());
  const size_t ybs = (size_t)Tpad * C;
  for (int blk = 1; blk <= nb; ++blk) {
    const bf16* w1_b = w1c_ + (size_t)blk * C * H;
    const float* vec_b = vecs_ + (size_t)blk * 8 * H;
    block_p1_kernel<<<p1_blocks, P1_WGS * WG, smem_p1(H), stream>>>(
        y_, ybs, y_, ybs, p_, part2_, part1_, cs_ + (size_t)(blk - 1) * 2 * C, w1_b, vec_b,
        alphas_ + 2 * blk, nullptr, 0, blk == 1 ? UPD_FIRST : UPD_ADD, B, T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    block_p2_kernel<<<p2_blocks, P2_WGS * WG, SMEM_P2, stream>>>(
        y_, ybs, part1_, part2_, w1_b, vec_b, alphas_ + 2 * blk, wsgc_ + (size_t)blk * H * C, p_,
        nullptr, 0, dils[blk - 1], B, T, Tpad, H, n_tiles);
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
// block_p1_kernel + block_p2_kernel, then tcn_epilogue_kernel =
// tcn_separator_launches(nb) launches.  x [B, T, 128] bf16 -> y [B, T,
// 128] bf16, and the state the backward needs: y_hist [B, nb, Tpad, 128]
// bf16, each block's input (y_hist[:, 0] = x; rows >= T zero), and stats
// [B, nb, 4] f32, each block's (mean1, rstd1, mean2, rstd2).  Block b's P1
// reads y_hist[:, b-1] and writes y_hist[:, b], from which its P2
// recomputes h, so the history is the chain's only y buffer.  Weights:
// w1c, wsgc as in convtasnet_separator, nb blocks.  Scratch: p [B, Tpad,
// 128] f32, part1/part2 [B, n_tiles, 2] f32.  nb >= 1.  Returns a
// cudaError_t.
extern "C" int tcn_separator(const void* x, const void* w1c, const void* wsgc, const void* vecs,
                             const void* cs, const void* alphas, void* y, void* y_hist,
                             void* stats, void* p, void* part1, void* part2, int B, int T, int H,
                             int nb, const int* dils, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (T + TILE - 1) / TILE, Tpad = n_tiles * TILE;
  int p1_blocks, p2_blocks;
  RETURN_IF_ERROR(body_setup(B, n_tiles, H, &p1_blocks, &p2_blocks));
  const bf16* w1c_ = static_cast<const bf16*>(w1c);
  const bf16* wsgc_ = static_cast<const bf16*>(wsgc);
  const float* vecs_ = static_cast<const float*>(vecs);
  const float* cs_ = static_cast<const float*>(cs);
  const float* alphas_ = static_cast<const float*>(alphas);
  bf16* yh = static_cast<bf16*>(y_hist);
  float* st = static_cast<float*>(stats);
  float* p_ = static_cast<float*>(p);
  float* part1_ = static_cast<float*>(part1);
  float* part2_ = static_cast<float*>(part2);
  const dim3 grid(n_tiles, B);
  const size_t slot = (size_t)Tpad * C, hbs = (size_t)nb * slot;
  const int st_bs = 4 * nb;

  for (int blk = 0; blk < nb; ++blk) {
    const bf16* y_in = blk == 0 ? static_cast<const bf16*>(x) : yh + (blk - 1) * slot;
    const bf16* w1_b = w1c_ + (size_t)blk * C * H;
    const float* vec_b = vecs_ + (size_t)blk * 8 * H;
    block_p1_kernel<<<p1_blocks, P1_WGS * WG, smem_p1(H), stream>>>(
        y_in, blk == 0 ? (size_t)T * C : hbs, yh + blk * slot, hbs, p_, part2_, part1_,
        cs_ + (size_t)(blk > 0 ? blk - 1 : 0) * 2 * C, w1_b, vec_b, alphas_ + 2 * blk,
        blk > 0 ? st + 4 * (blk - 1) + 2 : nullptr, st_bs, blk == 0 ? UPD_COPY : UPD_ADD, B, T,
        Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
    block_p2_kernel<<<p2_blocks, P2_WGS * WG, SMEM_P2, stream>>>(
        yh + blk * slot, hbs, part1_, part2_, w1_b, vec_b, alphas_ + 2 * blk,
        wsgc_ + (size_t)blk * H * C, p_, st + 4 * blk, st_bs, dils[blk], B, T, Tpad, H, n_tiles);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  tcn_epilogue_kernel<<<grid, THREADS, 0, stream>>>(
      yh + (nb - 1) * slot, hbs, static_cast<bf16*>(y), p_, part2_, cs_ + (size_t)(nb - 1) * 2 * C,
      st + 4 * (nb - 1) + 2, st_bs, T, Tpad, H, n_tiles);
  RETURN_IF_ERROR(cudaGetLastError());
  return 0;
}
