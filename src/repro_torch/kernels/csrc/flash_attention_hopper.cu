// K2 on Hopper's tensor cores: the "tc" route of kernels/flash_attention.py,
// flash attention forward and backward in bf16 with the contract of the JAX
// model's models/blocks.py:flash_attention_jnp (see flash_attention.cu, the
// "simt" route, for the contract in full): q (B, Sq, Hq, D), k and v (B, Sk,
// Hkv, D), query head h reads kv head h / group, per-row q_pos and key
// validity k_pos >= 0, the causal and window masks, the logit scale, P
// rounded to bf16 before the PV product with f32 accumulation, out in bf16
// and lse (B, Hq, Sq) in f32.  D is 64 or 128; the wrapper routes here only
// when q, k, v, out and dout start on 16 bytes, as TMA requires (their row
// strides, H * D * 2 bytes, are multiples of 16 for these D).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (pallas_call at :93), forward only on the TPU; the backward
// computes what jax.grad of flash_attention_jnp does.
//
// Bound on an H100: operations.  At d = 64 every K/V element read feeds
// 2 * 128 flops per q tile, and a causal layer of tinyllama (4 x 2048, 32
// heads) is 68.7 GFLOP forward, 0.07 ms at 989 TFLOP/s in bf16.  The design
// feeds wgmma from shared memory filled by TMA:
//
//   - q, k, v, dout keep their (B, S, H, D) layout: a 4-D tensor map (D, H,
//     S, B) reads boxes of rows x 64 columns of one head (128 bytes, the
//     width of the 128-byte swizzle; D = 128 is two boxes), and zero-fills
//     rows past S.  Masks, not the zero fill, keep those rows out.
//   - Each CTA first walks its q_pos and k_pos once and writes the list of
//     tiles with at least one allowed entry, each marked "full" (no mask
//     needed) or "partial" (the causal diagonal, the window edge, invalid or
//     out-of-range keys or rows).  Empty tiles are never loaded; masks are
//     applied only on partial tiles.  The CTA's resident tiles (Q, or K and
//     V) are requested before the walk, so their loads overlap it.
//   - One producer warp keeps a 2-stage TMA + mbarrier ring full; consumer
//     warp groups of 64 rows run wgmma m64nNk16 and free a stage when the
//     products that read it have retired.
//   - At d = 64 two CTAs share an SM (at most 112 registers a thread in the
//     forward and the dq pass), so that one CTA's tile walk, first loads
//     and epilogue overlap the other's products.  With one CTA an SM that
//     fixed cost per CTA left the tensor cores idle, and neither
//     software-pipelining S of the next tile under the softmax, nor FA3's
//     ping-pong of two warp groups over named barriers, nor a deeper ring
//     moved the time (PERF.md).
//
// k2_tc_fwd: one CTA per (128-row q tile, q head, batch), two consumer warp
// groups and the producer warp, the q tiles with the longest causal rows
// launched first.  K and V stream in 64-key tiles.  S = Q K^T with both
// operands K-major in shared memory; the online softmax runs on the
// accumulator fragments in f32, each row's max reduced over the 4 threads
// that hold it, with p = exp2((s - m) * scale * log2 e) as one FMA and
// ex2.approx (the scale multiplies after the product: at d = 64 the scale
// 1/8 is a power of two, so s * scale is the plain version's (q scale) . k
// term by term), and the plain version's NEG_INF arithmetic (a row masked
// within one tile before it has seen a key gets p = 1 there, wiped by the
// first allowed key).  P is rounded to bf16 in registers and is the register
// A operand of O += P V (the RS form of wgmma): the m64nNk16 f32
// accumulator's registers 8j..8j+7 are exactly the k16 slice j of the A
// fragment, packed in pairs, so P never goes to shared memory.  V's (keys,
// d) tile is MN-major for B (the transpose bit, as K1's w).
//
// Backward (FlashAttention-2 with P recomputed from lse), three kernels and
// no atomics, so dq, dk and dv are the same bits from run to run:
//   k2_tc_bwd_delta: delta = rowsum(dout * out) in f32, one thread a row;
//   k2_tc_bwd_dq:   as the forward's CTA, Q and dO resident, K and V
//                   streamed in 32-key tiles at d = 64 (64 at d = 128):
//                   S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K
//                   (RS form, K MN-major);
//   k2_tc_bwd_dkdv: one CTA per (64-key tile, kv head, batch), one consumer
//                   warp group, the early (heavy, under the causal mask) key
//                   tiles first; K and V resident, the group's q heads and
//                   their non-empty 64-row q tiles streamed, Q and dO by TMA
//                   and the rows' lse, delta and positions by cp.async
//                   arriving on the same stage barrier: S^T = K Q^T, P^T,
//                   dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - delta),
//                   dK += dS^T Q.  64-key tiles give 512 CTAs of more even
//                   work at the path's shape than 256 of 128 keys.
// dS enters its products (dQ and dK) rounded to bf16, where the plain
// backward keeps it in f32: one bf16 rounding (relative 2^-9) of each term
// of a sum over a whole row or column.  chip_smoke.py phase 5 measures the
// effect at the main paths' shapes with the plain backward with dS rounded
// the same way: ||error|| / ||plain|| of dq and dk 2.5-2.7e-3 (on an H100),
// nearly all of the tc route's own 2.5-2.7e-3; the tc route is within
// 1e-4 (dq) and 4e-4 (dk) of that rounded backward.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int STAGES = 2;     // depth of every ring
constexpr int THREADS = 288;  // forward and dq: two consumer warp groups
                              // and one producer warp
constexpr int MAX_SMEM = 232448;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const int* q_pos; const int* k_pos;
  bf16* out; float* lse;                      // forward outputs
  const float* lse_in; float* delta;          // backward
  bf16* dq; bf16* dk; bf16* dv;
  int B, Sq, Sk, Hq, Hkv, group, causal, window;
  float scale;
};

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence or the wait
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void zero(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// 4 bytes from global to shared memory, asynchronously; `bytes` 0 writes 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// A tile of `rows` rows x D columns, as TMA lays it down: D / 64 blocks of
// rows x 128 bytes, 128-byte swizzled.  K-major operand (A, or B whose N
// runs along the rows): rows r0 .. of k16 slice kk.  MN-major B (K runs
// along the rows, N along the D columns): k16 slice kk.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r0, int kk) {
  return make_desc(tile + (kk / 4) * rows * 128 + r0 * 128 + (kk % 4) * 32,
                   16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool allowed(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  if (causal) {
    if (qp < kp) return false;
    if (window && qp - kp >= window) return false;
  }
  return true;
}

// min and max of the positions pos[i0 .. i0 + len) below `limit` (keys:
// only the valid ones, >= 0) and their count, reduced over one warp
struct Span { int lo, hi, n; };

__device__ Span warp_span(const int* pos, int i0, int len, int limit, bool keys) {
  const int lane = threadIdx.x % 32;
  Span s = {0x7fffffff, -0x7fffffff - 1, 0};
  for (int i = lane; i < len && i0 + i < limit; i += 32) {
    const int p = pos[i0 + i];
    if (!keys || p >= 0) {
      s.lo = min(s.lo, p);
      s.hi = max(s.hi, p);
      ++s.n;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.lo = min(s.lo, __shfl_xor_sync(0xffffffffu, s.lo, o));
    s.hi = max(s.hi, __shfl_xor_sync(0xffffffffu, s.hi, o));
    s.n += __shfl_xor_sync(0xffffffffu, s.n, o);
  }
  return s;
}

// 0: no allowed entry in the (q tile, k tile) pair; 1: some, masks needed;
// 2: every entry allowed.  q_all / k_all: every row / key the kernel keeps
// is present and valid (rows or keys whose results are dropped need no
// mask).
__device__ int tile_flag(Span q, bool q_all, Span k, bool k_all, int causal,
                         int window) {
  if (q.n == 0 || k.n == 0) return 0;
  if (causal) {
    if (k.lo > q.hi) return 0;
    if (window && (int64_t)q.lo - k.hi >= window) return 0;
  }
  bool all = q_all && k_all;
  if (causal)
    all = all && k.hi <= q.lo && (!window || (int64_t)q.hi - k.lo < window);
  return all ? 2 : 1;
}

// list[0 .. n): tile t with at least one allowed entry as 2 t + (partial);
// on entry list[t] holds tile t's flag.  Returns n.
__device__ int compact(int* list, int ntiles) {
  int n = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int f = list[t];
    if (f) list[n++] = 2 * t + (f == 1);
  }
  return n;
}

// The list (see compact) of k tiles of BK keys with an allowed entry for the
// CTA's q rows [q0, q0 + BQ), the forward's and the dq pass's; rows past Sq
// are dropped, so need no mask.  Every thread of the CTA calls it.
template <int BQ, int BK>
__device__ int k_tile_list(int* list, const int* qpos, int q0, const Args& a) {
  __shared__ Span s_q;
  __shared__ int s_n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    const Span q = warp_span(qpos, q0, BQ, a.Sq, false);
    if (lane == 0) s_q = q;
  }
  __syncthreads();
  const int nkt = (a.Sk + BK - 1) / BK;
  for (int t = warp; t < nkt; t += blockDim.x / 32) {
    const Span k = warp_span(a.k_pos, t * BK, BK, a.Sk, true);
    if (lane == 0) list[t] = tile_flag(s_q, true, k, k.n == BK, a.causal, a.window);
  }
  __syncthreads();
  if (threadIdx.x == 0) s_n = compact(list, nkt);
  __syncthreads();
  return s_n;
}

// ------------------------------------------------------------------ forward
template <int D>
struct Fwd {
  // at d = 64 two CTAs share an SM (112 registers a thread), so that one's
  // tile list, first loads and epilogue overlap the other's products
  static constexpr int BQ = 128, BK = 64, HALVES = D / 64;
  static constexpr int CTAS_PER_SM = D == 64 ? 2 : 1;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int LIST_OFFSET = BAR_OFFSET + (2 * STAGES + 1) * 8;
};

// The online softmax of one S tile (raw Q K^T in the accumulator fragments
// of rows g and g + 8, registers 4c + {0, 1} and 4c + {2, 3}): masks a
// partial tile, updates the rows' max m (raw units) and sum l (this
// thread's columns), leaves P in f32 in place of S, and returns the
// corrections of the earlier O in c0, c1.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float* sc, float& m0, float& m1, float& l0, float& l1, float& c0,
    float& c1, int e, int qp0, int qp1, const Args& a, float sl2, int t4) {
  if (e & 1) {
    const int k0 = (e >> 1) * BK;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + 8 * c + 2 * t4 + j;
        const int kp = col < a.Sk ? __ldg(a.k_pos + col) : -1;
        if (!allowed(qp0, kp, a.causal, a.window)) sc[4 * c + j] = NEG_INF;
        if (!allowed(qp1, kp, a.causal, a.window)) sc[4 * c + 2 + j] = NEG_INF;
      }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  c0 = ex2((m0 - mx0) * sl2);
  c1 = ex2((m1 - mx1) * sl2);
  m0 = mx0;
  m1 = mx1;
  // p = exp2((s - m) sl2) as one FMA; a row that has seen only masked
  // entries (m = NEG_INF) gets p = 1 there, as the plain version's
  // exp(NEG_INF - NEG_INF)
  const float f0 = mx0 == NEG_INF ? 0.0f : sl2, f1 = mx1 == NEG_INF ? 0.0f : sl2;
  const float ms0 = mx0 * f0, ms1 = mx1 * f1;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
    sc[4 * c] = ex2(fmaf(sc[4 * c], f0, -ms0));
    sc[4 * c + 1] = ex2(fmaf(sc[4 * c + 1], f0, -ms0));
    sc[4 * c + 2] = ex2(fmaf(sc[4 * c + 2], f1, -ms1));
    sc[4 * c + 3] = ex2(fmaf(sc[4 * c + 3], f1, -ms1));
    s0 += sc[4 * c] + sc[4 * c + 1];
    s1 += sc[4 * c + 2] + sc[4 * c + 3];
  }
  l0 = l0 * c0 + s0;
  l1 = l1 * c1 + s1;
}

// P (f32 accumulator fragments, BK columns) rounded to bf16 pairs: the A
// fragments of the RS-form wgmma, k16 slice j being registers 8j .. 8j + 7
template <int BK>
__device__ __forceinline__ void pack_a(const float* p, uint32_t (*pa)[4]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[j][r] = pack(p[8 * j + 2 * r], p[8 * j + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(THREADS, Fwd<D>::CTAS_PER_SM)
k2_tc_fwd(const __grid_constant__ CUtensorMap map_q,
          const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, Args a) {
  using L = Fwd<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::BAR_OFFSET;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_bar = bars + 16 * STAGES;
  int* list = reinterpret_cast<int*>(gbase + L::LIST_OFFSET);

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, kh = h / a.group;
  const int* qpos = a.q_pos + (int64_t)b * a.Sq;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // lane 0 of each of the 8 consumer warps
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q does not depend on the tile list: its load overlaps the list's
    mbar_expect_tx(q_bar, L::Q_BYTES);
    for (int hf = 0; hf < L::HALVES; ++hf)
      tma_load_4d(base + hf * BQ * 128, &map_q, q_bar, 64 * hf, h, q0, b);
  }
  const int n = k_tile_list<BQ, BK>(list, qpos, q0, a);
  const uint32_t q_s = base;
  auto k_tile = [&](int s) { return base + L::Q_BYTES + s * L::STAGE_BYTES; };

  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full ----
    if (tid == 256) {
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        const int k0 = (list[i] >> 1) * BK;
        const uint32_t k_s = k_tile(s), v_s = k_s + L::KV_BYTES;
        mbar_expect_tx(full(s), L::STAGE_BYTES);
        for (int hf = 0; hf < L::HALVES; ++hf) {
          tma_load_4d(k_s + hf * BK * 128, &map_k, full(s), 64 * hf, kh, k0, b);
          tma_load_4d(v_s + hf * BK * 128, &map_v, full(s), 64 * hf, kh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warp group wg owns rows q0 + wg*64 .. + 63 ----
    const int w4 = warp % 4, g = lane / 4, t4 = lane % 4;
    // this thread's rows of S and O: row0 and row0 + 8; its columns of
    // register r: 8 (r >> 2) + 2 t4 + (r & 1)
    const int row0 = q0 + wg * 64 + w4 * 16 + g, row1 = row0 + 8;
    const int qp0 = row0 < a.Sq ? qpos[row0] : 0;
    const int qp1 = row1 < a.Sq ? qpos[row1] : 0;
    const float sl2 = a.scale * LOG2E;
    float o[D / 2], sc[BK / 2];
    uint32_t pa[BK / 16][4];
    zero<D / 2>(o);
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f, c0 = 1.0f, c1 = 1.0f;
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const uint32_t k_s = k_tile(s), v_s = k_s + L::KV_BYTES;
      mbar_wait(full(s), (i / STAGES) & 1);
      zero<BK / 2>(sc);
      wg_fence();
      hold<BK / 2>(sc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, kmajor(q_s, BQ, wg * 64, kk), kmajor(k_s, BK, 0, kk));
      wg_commit_wait();
      hold<BK / 2>(sc);
      softmax_tile<BK>(sc, m0, m1, l0, l1, c0, c1, list[i], qp0, qp1, a, sl2,
                       t4);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= c0;
        o[4 * c + 1] *= c0;
        o[4 * c + 2] *= c1;
        o[4 * c + 3] *= c1;
      }
      pack_a<BK>(sc, pa);
      wg_fence();
      hold<D / 2>(o);
      hold<BK / 4>(&pa[0][0]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D, 1>(o, pa[kk], mnmajor(v_s, BK, kk));
      wg_commit_wait();
      hold<D / 2>(o);
      hold<BK / 4>(&pa[0][0]);
      if (lane == 0) mbar_arrive(empty(s));
    }
    // each thread summed its own columns of a row: add the row's 4 threads
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    const int col = 2 * t4;
    if (row0 < a.Sq) {
      bf16* orow = a.out + (((int64_t)b * a.Sq + row0) * a.Hq + h) * D + col;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) =
            pack(o[4 * c] / lc0, o[4 * c + 1] / lc0);
      if (t4 == 0)
        a.lse[((int64_t)b * a.Hq + h) * a.Sq + row0] =
            (m0 == NEG_INF ? NEG_INF : m0 * a.scale) + logf(lc0);
    }
    if (row1 < a.Sq) {
      bf16* orow = a.out + (((int64_t)b * a.Sq + row1) * a.Hq + h) * D + col;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) =
            pack(o[4 * c + 2] / lc1, o[4 * c + 3] / lc1);
      if (t4 == 0)
        a.lse[((int64_t)b * a.Hq + h) * a.Sq + row1] =
            (m1 == NEG_INF ? NEG_INF : m1 * a.scale) + logf(lc1);
    }
  }
}

// ----------------------------------------------------------- backward delta
template <int D>
__global__ void __launch_bounds__(256)
k2_tc_bwd_delta(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                float* __restrict__ delta, int B, int Sq, int Hq) {
  const int64_t row = (int64_t)blockIdx.x * 256 + threadIdx.x;  // (b, s, h)
  if (row >= (int64_t)B * Sq * Hq) return;
  const uint4* o = reinterpret_cast<const uint4*>(out + row * D);
  const uint4* d = reinterpret_cast<const uint4*>(dout + row * D);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint4 x = o[i], y = d[i];
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 u = __bfloat1622float2(xp[j]), v = __bfloat1622float2(yp[j]);
      acc = fmaf(u.x, v.x, acc);
      acc = fmaf(u.y, v.y, acc);
    }
  }
  const int h = static_cast<int>(row % Hq);
  const int64_t bs = row / Hq;
  delta[((bs / Sq) * Hq + h) * Sq + bs % Sq] = acc;
}

// -------------------------------------------------------------- backward dq
template <int D>
struct Dq {
  // at d = 64 two CTAs share an SM (112 registers a thread: 32-key tiles),
  // as in the forward
  static constexpr int BQ = 128, BK = D == 64 ? 32 : 64, HALVES = D / 64;
  static constexpr int CTAS_PER_SM = D == 64 ? 2 : 1;
  static constexpr int Q_BYTES = BQ * D * 2;         // Q and dO each
  static constexpr int KV_BYTES = BK * D * 2;        // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFFSET = 2 * Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int LIST_OFFSET = BAR_OFFSET + (2 * STAGES + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(THREADS, Dq<D>::CTAS_PER_SM)
k2_tc_bwd_dq(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_do,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, Args a) {
  using L = Dq<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::BAR_OFFSET;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_bar = bars + 16 * STAGES;
  int* list = reinterpret_cast<int*>(gbase + L::LIST_OFFSET);

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, kh = h / a.group;
  const int* qpos = a.q_pos + (int64_t)b * a.Sq;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q and dO do not depend on the tile list: their loads overlap it
    mbar_expect_tx(q_bar, 2 * L::Q_BYTES);
    for (int hf = 0; hf < L::HALVES; ++hf) {
      tma_load_4d(base + hf * BQ * 128, &map_q, q_bar, 64 * hf, h, q0, b);
      tma_load_4d(base + L::Q_BYTES + hf * BQ * 128, &map_do, q_bar, 64 * hf,
                  h, q0, b);
    }
  }
  const int n = k_tile_list<BQ, BK>(list, qpos, q0, a);
  const uint32_t q_s = base, do_s = base + L::Q_BYTES;
  auto k_tile = [&](int s) { return base + 2 * L::Q_BYTES + s * L::STAGE_BYTES; };

  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full ----
    if (tid == 256) {
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        const int k0 = (list[i] >> 1) * BK;
        const uint32_t k_s = k_tile(s), v_s = k_s + L::KV_BYTES;
        mbar_expect_tx(full(s), L::STAGE_BYTES);
        for (int hf = 0; hf < L::HALVES; ++hf) {
          tma_load_4d(k_s + hf * BK * 128, &map_k, full(s), 64 * hf, kh, k0, b);
          tma_load_4d(v_s + hf * BK * 128, &map_v, full(s), 64 * hf, kh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warp group wg owns rows q0 + wg*64 .. + 63 ----
    const int w4 = warp % 4, g = lane / 4, t4 = lane % 4;
    const int row0 = q0 + wg * 64 + w4 * 16 + g, row1 = row0 + 8;
    const int64_t lrow = ((int64_t)b * a.Hq + h) * a.Sq;
    const bool in0 = row0 < a.Sq, in1 = row1 < a.Sq;
    const int qp0 = in0 ? qpos[row0] : 0, qp1 = in1 ? qpos[row1] : 0;
    const float ls0 = in0 ? a.lse_in[lrow + row0] * LOG2E : 0.0f;
    const float ls1 = in1 ? a.lse_in[lrow + row1] * LOG2E : 0.0f;
    const float dl0 = in0 ? a.delta[lrow + row0] : 0.0f;
    const float dl1 = in1 ? a.delta[lrow + row1] : 0.0f;
    const float sl2 = a.scale * LOG2E;
    float dq[D / 2];
    zero<D / 2>(dq);
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int e = list[i];
      const int k0 = (e >> 1) * BK;
      const uint32_t k_s = k_tile(s), v_s = k_s + L::KV_BYTES;
      mbar_wait(full(s), (i / STAGES) & 1);
      float sc[BK / 2], dp[BK / 2];
      zero<BK / 2>(sc);
      zero<BK / 2>(dp);
      wg_fence();
      hold<BK / 2>(sc);
      hold<BK / 2>(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, kmajor(q_s, BQ, wg * 64, kk), kmajor(k_s, BK, 0, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, kmajor(do_s, BQ, wg * 64, kk), kmajor(v_s, BK, 0, kk));
      wg_commit_wait();
      hold<BK / 2>(sc);
      hold<BK / 2>(dp);
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        float ds[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p0 = ex2(fmaf(sc[4 * c + j], sl2, -ls0));
          float p1 = ex2(fmaf(sc[4 * c + 2 + j], sl2, -ls1));
          if (e & 1) {
            const int col = k0 + 8 * c + 2 * t4 + j;
            const int kp = col < a.Sk ? __ldg(a.k_pos + col) : -1;
            if (!allowed(qp0, kp, a.causal, a.window)) p0 = 0.0f;
            if (!allowed(qp1, kp, a.causal, a.window)) p1 = 0.0f;
          }
          ds[j] = p0 * (dp[4 * c + j] - dl0);
          ds[2 + j] = p1 * (dp[4 * c + 2 + j] - dl1);
        }
        da[c / 2][(c % 2) * 2] = pack(ds[0], ds[1]);
        da[c / 2][(c % 2) * 2 + 1] = pack(ds[2], ds[3]);
      }
      wg_fence();
      hold<D / 2>(dq);
      hold<BK / 4>(&da[0][0]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D, 1>(dq, da[kk], mnmajor(k_s, BK, kk));
      wg_commit_wait();
      hold<D / 2>(dq);
      hold<BK / 4>(&da[0][0]);
      if (lane == 0) mbar_arrive(empty(s));
    }
    const int col = 2 * t4;
    if (in0) {
      bf16* r = a.dq + (((int64_t)b * a.Sq + row0) * a.Hq + h) * D + col;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(r + 8 * c) =
            pack(dq[4 * c] * a.scale, dq[4 * c + 1] * a.scale);
    }
    if (in1) {
      bf16* r = a.dq + (((int64_t)b * a.Sq + row1) * a.Hq + h) * D + col;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(r + 8 * c) =
            pack(dq[4 * c + 2] * a.scale, dq[4 * c + 3] * a.scale);
    }
  }
}

// ------------------------------------------------------------ backward dk/dv
template <int D>
struct Dkdv {
  // one consumer warp group (64 keys) and one producer warp; at d = 64 two
  // CTAs share an SM
  static constexpr int BK = 64, BQ = 64, HALVES = D / 64;
  static constexpr int THREADS = 128 + 32;
  static constexpr int CTAS_PER_SM = D == 64 ? 2 : 1;
  static constexpr int KV_BYTES = BK * D * 2;        // K and V each, resident
  static constexpr int Q_BYTES = BQ * D * 2;         // Q and dO each, a stage
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  // per stage: the q rows' lse, delta and positions
  static constexpr int ROWS_OFFSET = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = ROWS_OFFSET + STAGES * 3 * BQ * 4;
  static constexpr int LIST_OFFSET = BAR_OFFSET + (2 * STAGES + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(Dkdv<D>::THREADS, Dkdv<D>::CTAS_PER_SM)
k2_tc_bwd_dkdv(const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_do, Args a) {
  using L = Dkdv<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::BAR_OFFSET;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t kv_bar = bars + 16 * STAGES;
  int* list = reinterpret_cast<int*>(gbase + L::LIST_OFFSET);
  auto rows_at = [&](int s) {
    return reinterpret_cast<float*>(gbase + L::ROWS_OFFSET) + s * 3 * BQ;
  };
  __shared__ int s_n, s_klo, s_khi, s_kn;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32;
  const int lane = tid % 32;
  const int kh = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int k0 = blockIdx.y * BK;
  const int nqt = (a.Sq + BQ - 1) / BQ;
  const int* qpos = a.q_pos + (int64_t)b * a.Sq;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA bytes and the producer warp's rows
      mbar_init(empty(s), 4);   // lane 0 of each consumer warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // K and V do not depend on the tile list: their loads overlap it
    mbar_expect_tx(kv_bar, 2 * L::KV_BYTES);
    for (int hf = 0; hf < L::HALVES; ++hf) {
      tma_load_4d(base + hf * BK * 128, &map_k, kv_bar, 64 * hf, kh, k0, b);
      tma_load_4d(base + L::KV_BYTES + hf * BK * 128, &map_v, kv_bar, 64 * hf,
                  kh, k0, b);
    }
  }
  if (warp == 0) {
    const Span k = warp_span(a.k_pos, k0, BK, a.Sk, true);
    if (lane == 0) { s_klo = k.lo; s_khi = k.hi; s_kn = k.n; }
  }
  __syncthreads();
  const Span k = {s_klo, s_khi, s_kn};
  const bool k_all = k.n == min(BK, a.Sk - k0);
  for (int t = warp; t < nqt; t += L::THREADS / 32) {
    const Span q = warp_span(qpos, t * BQ, BQ, a.Sq, false);
    if (lane == 0) list[t] = tile_flag(q, q.n == BQ, k, k_all, a.causal, a.window);
  }
  __syncthreads();
  if (tid == 0) s_n = compact(list, nqt);
  __syncthreads();
  const int n = s_n, items = n * a.group;
  const uint32_t k_s = base, v_s = base + L::KV_BYTES;
  auto q_tile = [&](int s) { return base + 2 * L::KV_BYTES + s * L::STAGE_BYTES; };

  if (wg == 1) {
    // ---- producer warp: Q, dO and the rows' lse, delta and positions
    // for each (q head of the group, q tile) ----
    for (int i = 0; i < items; ++i) {
      const int s = i % STAGES;
      const int h = kh * a.group + i / n;
      const int q0 = (list[i % n] >> 1) * BQ;
      mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t q_s = q_tile(s), do_s = q_s + L::Q_BYTES;
        mbar_expect_tx(full(s), L::STAGE_BYTES);
        for (int hf = 0; hf < L::HALVES; ++hf) {
          tma_load_4d(q_s + hf * BQ * 128, &map_q, full(s), 64 * hf, h, q0, b);
          tma_load_4d(do_s + hf * BQ * 128, &map_do, full(s), 64 * hf, h, q0, b);
        }
      }
      // the rows' lse, delta and positions by cp.async (zero past Sq): each
      // lane's copies arrive on the stage's barrier when they land, so the
      // warp goes on to the next stage without waiting for them
      const uint32_t rows = smem_u32(rows_at(s));
      const int64_t lrow = ((int64_t)b * a.Hq + h) * a.Sq;
      for (int r = lane; r < BQ; r += 32) {
        const int qr = min(q0 + r, a.Sq - 1);
        const uint32_t n_in = q0 + r < a.Sq ? 4 : 0;
        cp_async4(rows + 4 * r, a.lse_in + lrow + qr, n_in);
        cp_async4(rows + 4 * (BQ + r), a.delta + lrow + qr, n_in);
        cp_async4(rows + 4 * (2 * BQ + r), qpos + qr, n_in);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                   :: "r"(full(s)) : "memory");
    }
  } else {
    // ---- consumers: the warp group owns keys k0 .. k0 + 63 ----
    const int w4 = warp % 4, g = lane / 4, t4 = lane % 4;
    // this thread's keys (rows of S^T, dK, dV): key0 and key0 + 8; its q
    // rows (columns of S^T) of register r: 8 (r >> 2) + 2 t4 + (r & 1)
    const int key0 = k0 + w4 * 16 + g, key1 = key0 + 8;
    const int kp0 = key0 < a.Sk ? a.k_pos[key0] : -1;
    const int kp1 = key1 < a.Sk ? a.k_pos[key1] : -1;
    const float sl2 = a.scale * LOG2E;
    float dk[D / 2], dv[D / 2];
    zero<D / 2>(dk);
    zero<D / 2>(dv);
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < items; ++i) {
      const int s = i % STAGES;
      const int e = list[i % n];
      const int q0 = (e >> 1) * BQ;
      const uint32_t q_s = q_tile(s), do_s = q_s + L::Q_BYTES;
      mbar_wait(full(s), (i / STAGES) & 1);
      float st[BQ / 2], dpt[BQ / 2];
      zero<BQ / 2>(st);
      zero<BQ / 2>(dpt);
      wg_fence();
      hold<BQ / 2>(st);
      hold<BQ / 2>(dpt);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(st, kmajor(k_s, BK, 0, kk), kmajor(q_s, BQ, 0, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dpt, kmajor(v_s, BK, 0, kk), kmajor(do_s, BQ, 0, kk));
      wg_commit_wait();
      hold<BQ / 2>(st);
      hold<BQ / 2>(dpt);
      const float* rows = rows_at(s);
      const int* rpos = reinterpret_cast<const int*>(rows) + 2 * BQ;
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        float p[4], ds[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * c + 2 * t4 + j;
          const float ls = rows[col] * LOG2E, dl = rows[BQ + col];
          float p0 = ex2(fmaf(st[4 * c + j], sl2, -ls));
          float p1 = ex2(fmaf(st[4 * c + 2 + j], sl2, -ls));
          if (e & 1) {
            const int qp = rpos[col];
            const bool in = q0 + col < a.Sq;
            if (!in || !allowed(qp, kp0, a.causal, a.window)) p0 = 0.0f;
            if (!in || !allowed(qp, kp1, a.causal, a.window)) p1 = 0.0f;
          }
          p[j] = p0;
          p[2 + j] = p1;
          ds[j] = p0 * (dpt[4 * c + j] - dl);
          ds[2 + j] = p1 * (dpt[4 * c + 2 + j] - dl);
        }
        pa[c / 2][(c % 2) * 2] = pack(p[0], p[1]);
        pa[c / 2][(c % 2) * 2 + 1] = pack(p[2], p[3]);
        da[c / 2][(c % 2) * 2] = pack(ds[0], ds[1]);
        da[c / 2][(c % 2) * 2 + 1] = pack(ds[2], ds[3]);
      }
      wg_fence();
      hold<D / 2>(dv);
      hold<D / 2>(dk);
      hold<BQ / 4>(&pa[0][0]);
      hold<BQ / 4>(&da[0][0]);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dv, pa[kk], mnmajor(do_s, BQ, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dk, da[kk], mnmajor(q_s, BQ, kk));
      wg_commit_wait();
      hold<D / 2>(dv);
      hold<D / 2>(dk);
      hold<BQ / 4>(&pa[0][0]);
      hold<BQ / 4>(&da[0][0]);
      if (lane == 0) mbar_arrive(empty(s));
    }
    const int col = 2 * t4;
    if (key0 < a.Sk) {
      const int64_t off = (((int64_t)b * a.Sk + key0) * a.Hkv + kh) * D + col;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(a.dk + off + 8 * c) =
            pack(dk[4 * c] * a.scale, dk[4 * c + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + off + 8 * c) =
            pack(dv[4 * c], dv[4 * c + 1]);
      }
    }
    if (key1 < a.Sk) {
      const int64_t off = (((int64_t)b * a.Sk + key1) * a.Hkv + kh) * D + col;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(a.dk + off + 8 * c) =
            pack(dk[4 * c + 2] * a.scale, dk[4 * c + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + off + 8 * c) =
            pack(dv[4 * c + 2], dv[4 * c + 3]);
      }
    }
  }
}

// --------------------------------------------------------------------- host
// a (B, S, H, D) bf16 tensor read in boxes of `rows` rows x 64 columns (128
// bytes, the swizzle's width) of one head; reads past S are zero
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
            int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// raise the kernel's dynamic shared memory limit to `smem` where it is
// lower (the static part, 16 bytes, counts against the same 227 KB)
template <auto Kernel>
int prepare(size_t smem) {
  if (smem + 64 > (size_t)MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  static size_t allowed = 0;   // one limit per kernel
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  return 0;
}

constexpr int INVALID = static_cast<int>(cudaErrorInvalidValue);

template <int D>
int fwd(const void* q, const void* k, const void* v, const Args& a,
        cudaStream_t st) {
  using L = Fwd<D>;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, a.B, a.Sq, a.Hq, D, L::BQ) ||
      !encode(&mk, k, a.B, a.Sk, a.Hkv, D, L::BK) ||
      !encode(&mv, v, a.B, a.Sk, a.Hkv, D, L::BK))
    return INVALID;
  const size_t smem = L::LIST_OFFSET + 4 * ((a.Sk + L::BK - 1) / L::BK) + 1024;
  if (int err = prepare<k2_tc_fwd<D>>(smem)) return err;
  const dim3 grid(a.Hq * a.B, (a.Sq + L::BQ - 1) / L::BQ);
  k2_tc_fwd<D><<<grid, THREADS, smem, st>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* out,
        const void* dout, const Args& a, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.Hq;
  k2_tc_bwd_delta<D><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), a.delta,
      a.B, a.Sq, a.Hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  using Q = Dq<D>;
  CUtensorMap mq, mdo, mk, mv;
  if (!encode(&mq, q, a.B, a.Sq, a.Hq, D, Q::BQ) ||
      !encode(&mdo, dout, a.B, a.Sq, a.Hq, D, Q::BQ) ||
      !encode(&mk, k, a.B, a.Sk, a.Hkv, D, Q::BK) ||
      !encode(&mv, v, a.B, a.Sk, a.Hkv, D, Q::BK))
    return INVALID;
  size_t smem = Q::LIST_OFFSET + 4 * ((a.Sk + Q::BK - 1) / Q::BK) + 1024;
  if (int err = prepare<k2_tc_bwd_dq<D>>(smem)) return err;
  k2_tc_bwd_dq<D><<<dim3(a.Hq * a.B, (a.Sq + Q::BQ - 1) / Q::BQ),
                    THREADS, smem, st>>>(mq, mdo, mk, mv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  using K = Dkdv<D>;
  if (!encode(&mk, k, a.B, a.Sk, a.Hkv, D, K::BK) ||
      !encode(&mv, v, a.B, a.Sk, a.Hkv, D, K::BK) ||
      !encode(&mq, q, a.B, a.Sq, a.Hq, D, K::BQ) ||
      !encode(&mdo, dout, a.B, a.Sq, a.Hq, D, K::BQ))
    return INVALID;
  smem = K::LIST_OFFSET + 4 * ((a.Sq + K::BQ - 1) / K::BQ) + 1024;
  if (int err = prepare<k2_tc_bwd_dkdv<D>>(smem)) return err;
  k2_tc_bwd_dkdv<D><<<dim3(a.Hkv * a.B, (a.Sk + K::BK - 1) / K::BK),
                      K::THREADS, smem, st>>>(mk, mv, mq, mdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), out like q, all starting
// on 16 bytes; int32 q_pos (B, Sq) and k_pos (Sk,); f32 lse (B, Hq, Sq).
// D in {64, 128}.  Returns a CUDA error code (0 = success).
extern "C" int k2_tc_forward(const void* q, const void* k, const void* v,
                             const void* q_pos, const void* k_pos, void* out,
                             void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                             int D, int causal, int window, float scale,
                             void* stream) {
  Args a = {};
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.group = Hq / Hkv;
  a.causal = causal; a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd<64>(q, k, v, a, s);
  if (D == 128) return fwd<128>(q, k, v, a, s);
  return INVALID;
}

// as k2_tc_forward, plus out and dout (like q, on 16 bytes), lse from the
// forward, delta: f32 (B, Hq, Sq) scratch, and the gradients dq, dk, dv
// shaped as q, k, v.
extern "C" int k2_tc_backward(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, const void* q_pos,
                              const void* k_pos, void* delta, void* dq,
                              void* dk, void* dv, int B, int Sq, int Sk,
                              int Hq, int Hkv, int D, int causal, int window,
                              float scale, void* stream) {
  Args a = {};
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.group = Hq / Hkv;
  a.causal = causal; a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return bwd<64>(q, k, v, out, dout, a, s);
  if (D == 128) return bwd<128>(q, k, v, out, dout, a, s);
  return INVALID;
}
