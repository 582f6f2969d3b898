// K4, split route: paged flash-decode split over the block table's columns,
// then a combine pass that can fold in the current token.
//
// Replaces the Pallas kernel src/repro/kernels/paged_decode.py:_decode_kernel
// (via _pallas_impl, entry paged_flash_decode) for bf16 with dk = dv in
// {64, 128}, a group of 1, 2, 4 or 8 query rows per kv head, a block of 8,
// 16, 24 or 32 entries and tensors on 16 bytes (kernels/paged_decode.py:
// route); paged_decode.cu (simt) takes the rest.  Every attention layer of
// every fused decode step of tinyllama-1.1b takes this route.
//
// Contract (kernels/paged_decode.py of the reference): q (B,nq,D),
// k_pool / v_pool (phys,nkv,D), pos_pool (phys,) int32, tables (B,nb)
// int32, cur (B,) int32.  Entry e of slot b attends iff 0 <= pos <= cur
// (and cur - pos < window when windowed); p is masked again after the
// exponent.  Query rows group as q.reshape(B,nkv,G,D).
//
// Bound on an H100: bytes.  Each valid K/V element is read once for 4*G
// flops (QK and PV): 16 flops a byte at G = 8, far below the ~295 at which
// bf16 tensor cores would be the limit.  The tensor cores are used all the
// same, for another reason: in f32 FMA on the CUDA cores (a first design,
// chip_smoke.py phase 3 on an H100) the conversions, shuffles and
// exponentials around the 2*G*D FMAs of each entry took ~930 instructions
// a warp per 16-entry column and 254 registers, so the kernel was bound by
// instruction issue at a third of the bytes bound.  mma.sync does a
// column's QK and PV in 40 instructions and needs ~80 registers.
//
// Design.  The reference shards the table's columns over devices, each
// shard returning (acc, m, l), and combines them as
// sum acc*e^(m-M) / sum l*e^(m-M) before folding in the current token
// (src/repro/models/blocks.py:313-335).  Here the 132 SMs take the place of
// the devices and a second kernel that of the psum:
//
// k4_split, grid (splits, nkv, B), 4 warps a block.  A block takes `cols`
//   consecutive table columns of one slot and one kv head; warps take
//   columns in turn.  (Two or four kv heads a block, so that a warp reads
//   more of a pool row's contiguous (nkv, D), were measured no faster.)
//   The host sizes the grid to one wave of as many blocks as an SM holds
//   (k4_split_per_sm: 3 at d 64 and block 16, fewer with a larger ring),
//   since a second, partial wave costs more than it gains.  A warp first
//   reads the table ids of its columns and, lane j for column j, the
//   column's positions as 16-byte vectors, so that each lane holds its
//   column's validity as a bit mask: one round trip for all of them.
//   Columns with no valid entry (the null block, recycled blocks, columns
//   past cur or outside the window) are dropped there and their K/V never
//   read; a block left with none writes m = -1e30, l = 0, acc = 0.  The
//   live columns stream through a ring of `stages` columns per warp in
//   shared memory by cp.async (16 bytes a lane, invalid entries zero
//   filled without a read, rows swizzled for ldmatrix), so the next
//   columns' loads are in flight while the current one computes.  The
//   group's G query rows are the A operand of S = Q K^T (m16n8k16, rows
//   G..15 zero; f32 accumulation of exact bf16 products), 8 entries a
//   tile.  The online softmax runs on the accumulator fragments: each
//   query row lives on 4 lanes, one rescale per column, exp2 with the
//   scale and log2(e) applied to the f32 scores.  P feeds O += P V
//   (m16n8k8) from registers as bf16 hi + lo, so that the product keeps
//   P's f32 digits and the result the plain version's.  At the end the
//   warps of a head merge through shared memory in a fixed order, and the
//   block writes f32 partials (B, nq, splits, D) and m, l (B, nq, splits),
//   m in log2 units.
// k4_combine, one warp per (slot, query row): M = max_s m_s, acc =
//   sum_s acc_s 2^(m_s-M), l = sum_s l_s 2^(m_s-M) in split order (no
//   atomics: the result repeats bit for bit).  Mode 0 writes (acc, m, l)
//   with m in natural units (-1e30 where nothing was valid), mode 1
//   acc / l in bf16, mode 2 first folds the current token (k_new, v_new;
//   age 0, always valid) into the same softmax as blocks.py:322-335 does,
//   then writes the normalised bf16 output.
// Both kernels take their sizes from the host and read no device value
// there, so both can be captured in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.69314718055994531f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_BLOCK = 32;       // entries a table column may hold here
constexpr int SMEM_MAX = 160 * 1024;

struct SplitArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_pool;
  const __nv_bfloat16* v_pool;
  const int* pos_pool;
  const int* tables;
  const int* cur;
  float* acc;                       // (B, nq, splits, D)
  float* m;                         // (B, nq, splits), log2 units
  float* l;                         // (B, nq, splits)
  int nq, nkv, block, nb, n_blocks, window, splits, cols, stages;
  float qscale;                     // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero filled without a read when
// !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c += A B with rows 8-15 of A zero (a0: row lane/4, k 0-7; a1: k 8-15), so
// only the first two accumulators of the fragment are kept
__device__ __forceinline__ void mma_k16(float& c0, float& c1, uint32_t a0,
                                        uint32_t a1, uint32_t b0,
                                        uint32_t b1) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(c0), "=f"(c1), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a1), "r"(0u), "r"(b0), "r"(b1), "f"(c0),
        "f"(c1), "f"(0.0f), "f"(0.0f));
}
__device__ __forceinline__ void mma_k8(float& c0, float& c1, uint32_t a0,
                                       uint32_t b0) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%7,%8,%9,%10};\n"
      : "=f"(c0), "=f"(c1), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(b0), "f"(c0), "f"(c1), "f"(0.0f), "f"(0.0f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool valid_pos(int p, int cur, int window) {
  return p >= 0 && p <= cur && (window == 0 || cur - p < window);
}

template <int D, int G>
__global__ void __launch_bounds__(THREADS)
k4_split(const SplitArgs a) {
  constexpr int CPR = D / 8;        // 16-byte chunks of a K or V row
  constexpr int KS = D / 16;        // k16 steps of a score
  constexpr int NT = D / 8;         // 8-wide dim tiles of the output
  constexpr int TM = MAX_BLOCK / 8; // 8-entry tiles a column may hold
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, quad = lane & 3;  // fragment row, column pair
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c_begin = split * a.cols;
  const int c_end = min(c_begin + a.cols, a.nb);
  const int cur = a.cur[b];
  const int tiles = a.block / 8;
  const int chunks = a.block * CPR;  // of K (and of V) in one column
  const int stage_bytes = a.block * 2 * D * 2;  // K rows, then V rows
  const uint32_t ring = smem_addr(smem) + w * a.stages * stage_bytes;

  // Q as the A operand of S = Q K^T: row g of the fragment is query row g
  // of the group; rows G..15 are zero
  const int64_t row0 = (int64_t)b * a.nq + (int64_t)h * G;
  uint32_t qa[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = qa[ks][1] = 0u;
    if (g < G) {
      const __nv_bfloat16* qp = a.q + (row0 + g) * D + ks * 16 + quad * 2;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qp);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qp + 8);
    }
  }
  // row g's running max (log2 units) and sum, and its output columns
  // n*8 + quad*2 + {0, 1}
  float m_r = NEG_INF, l_r = 0.0f, o[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = 0.0f;

  for (int first = c_begin + w; first < c_end; first += 32 * WARPS) {
    // lane j: column first + j * WARPS, its block id and validity bits
    const int col = first + lane * WARPS;
    int blk = 0;
    uint32_t mask = 0;
    if (col < c_end) {
      blk = a.tables[(int64_t)b * a.nb + col];
      if (blk >= 0 && blk < a.n_blocks) {
        const int4* pp =
            reinterpret_cast<const int4*>(a.pos_pool + (int64_t)blk * a.block);
        int4 p4[MAX_BLOCK / 4];
#pragma unroll
        for (int e4 = 0; e4 < MAX_BLOCK / 4; ++e4)
          if (4 * e4 < a.block) p4[e4] = __ldg(pp + e4);
#pragma unroll
        for (int e4 = 0; e4 < MAX_BLOCK / 4; ++e4) {
          if (4 * e4 < a.block) {
            mask |= (uint32_t)valid_pos(p4[e4].x, cur, a.window) << (4 * e4);
            mask |= (uint32_t)valid_pos(p4[e4].y, cur, a.window) << (4 * e4 + 1);
            mask |= (uint32_t)valid_pos(p4[e4].z, cur, a.window) << (4 * e4 + 2);
            mask |= (uint32_t)valid_pos(p4[e4].w, cur, a.window) << (4 * e4 + 3);
          }
        }
      }
    }
    uint32_t to_issue = __ballot_sync(FULL, mask != 0);
    uint32_t to_do = to_issue;

    // one live column into ring stage st, 16 bytes a lane at a time; chunk
    // c of row e lands at chunk c ^ (e & 7) of its row, so that ldmatrix
    // reads 8 rows without bank conflicts
    auto issue = [&](int st) {
      if (to_issue) {
        const int j = __ffs(to_issue) - 1;
        to_issue &= to_issue - 1;
        const int64_t base = (int64_t)__shfl_sync(FULL, blk, j) * a.block;
        const uint32_t cm = __shfl_sync(FULL, mask, j);
        const uint32_t dst = ring + st * stage_bytes;
        for (int i = lane; i < chunks; i += 32) {
          const int e = i / CPR, c = i % CPR;
          const int64_t off = ((base + e) * a.nkv + h) * D + c * 8;
          const uint32_t at = (e * CPR + (c ^ (e & 7))) * 16;
          const bool ok = (cm >> e) & 1u;
          cp_async16(dst + at, a.k_pool + off, ok);
          cp_async16(dst + chunks * 16 + at, a.v_pool + off, ok);
        }
      }
      cp_async_commit();   // an empty group past the last live column
    };

    for (int st = 0; st < a.stages - 1; ++st) issue(st);
    for (int i = 0; to_do; ++i) {
      const int j = __ffs(to_do) - 1;
      to_do &= to_do - 1;
      const uint32_t cm = __shfl_sync(FULL, mask, j);
      // every lane is done with stage (i - 1) % stages: refill it
      __syncwarp();
      issue((i + a.stages - 1) % a.stages);
      // at most stages - 1 groups pending: column i has landed
      if (a.stages == 4) cp_async_wait<3>();
      else if (a.stages == 3) cp_async_wait<2>();
      else cp_async_wait<1>();
      __syncwarp();
      const uint32_t kb = ring + (i % a.stages) * stage_bytes;
      const uint32_t vb = kb + chunks * 16;

      // S = Q K^T, 8 entries a tile: s[t][k] is row g, entry t*8+quad*2+k
      float s[TM][2];
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        s[t][0] = s[t][1] = 0.0f;
        if (t < tiles) {
          const int e = t * 8 + (lane & 7);
#pragma unroll
          for (int ks = 0; ks < KS; ks += 2) {
            const int c = ks * 2 + (lane >> 3);
            uint32_t kf[4];
            ldsm_x4(kb + (e * CPR + (c ^ (e & 7))) * 16, kf);
            mma_k16(s[t][0], s[t][1], qa[ks][0], qa[ks][1], kf[0], kf[1]);
            mma_k16(s[t][0], s[t][1], qa[ks + 1][0], qa[ks + 1][1], kf[2],
                    kf[3]);
          }
        }
      }
      // row g's online softmax over the column (its 4 lanes hold it)
      float mx = m_r;
#pragma unroll
      for (int t = 0; t < TM; ++t)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          s[t][k] *= a.qscale;
          if (t < tiles && ((cm >> (t * 8 + quad * 2 + k)) & 1u))
            mx = fmaxf(mx, s[t][k]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float alpha = exp2f(m_r - mx);
      m_r = mx;
      l_r *= alpha;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha;
        o[n][1] *= alpha;
      }
      // O += P V, P split into bf16 hi + lo so that it keeps f32's digits
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        if (t < tiles) {
          float p[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            p[k] = ((cm >> (t * 8 + quad * 2 + k)) & 1u)
                       ? exp2f(s[t][k] - mx) : 0.0f;
            l_r += p[k];
          }
          const uint32_t hi = pack_bf16(p[0], p[1]);
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi);
          const float2 hf = __bfloat1622float2(hv);
          const uint32_t lo = pack_bf16(p[0] - hf.x, p[1] - hf.y);
          const int e = t * 8 + (lane & 7);
#pragma unroll
          for (int nn = 0; nn < NT; nn += 4) {
            const int c = nn + (lane >> 3);
            uint32_t vf[4];
            ldsm_x4_t(vb + (e * CPR + (c ^ (e & 7))) * 16, vf);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              mma_k8(o[nn + x][0], o[nn + x][1], hi, vf[x]);
              mma_k8(o[nn + x][0], o[nn + x][1], lo, vf[x]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();     // the ring is free for the next 32 columns
  }
  l_r += __shfl_xor_sync(FULL, l_r, 1);
  l_r += __shfl_xor_sync(FULL, l_r, 2);

  // merge the warps through shared memory (over the ring)
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);   // [WARPS][G]
  float* wl = wm + WARPS * G;                   // [WARPS][G]
  float* wacc = wl + WARPS * G;                 // [WARPS][G][D]
  if (g < G) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      wacc[(w * G + g) * D + n * 8 + quad * 2] = o[n][0];
      wacc[(w * G + g) * D + n * 8 + quad * 2 + 1] = o[n][1];
    }
    if (quad == 0) {
      wm[w * G + g] = m_r;
      wl[w * G + g] = l_r;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float mx = NEG_INF;
    for (int ww = 0; ww < WARPS; ++ww) mx = fmaxf(mx, wm[ww * G + r]);
    float acc = 0.0f, ls = 0.0f;
    for (int ww = 0; ww < WARPS; ++ww) {
      const float sc = exp2f(wm[ww * G + r] - mx);
      acc = fmaf(wacc[(ww * G + r) * D + d], sc, acc);
      ls = fmaf(wl[ww * G + r], sc, ls);
    }
    const int64_t row = (int64_t)b * a.nq + (int64_t)h * G + r;
    const int64_t slot = row * a.splits + split;
    a.acc[slot * D + d] = acc;
    if (d == 0) {
      a.m[slot] = mx;
      a.l[slot] = ls;
    }
  }
}

struct CombineArgs {
  const float* acc;                 // (B, nq, splits, D)
  const float* m;                   // (B, nq, splits), log2 units
  const float* l;
  const __nv_bfloat16* q;           // (B, nq, D), mode 2
  const __nv_bfloat16* k_new;       // (B, nkv, D), mode 2
  const __nv_bfloat16* v_new;       // (B, nkv, D), mode 2
  void* out;                        // f32 acc (mode 0) or bf16 (1, 2)
  float* m_out;                     // mode 0, natural units
  float* l_out;                     // mode 0
  int rows, nq, nkv, splits, mode;
  float qscale;                     // scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(THREADS) k4_combine(const CombineArgs c) {
  constexpr int VPL = D / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= c.rows) return;
  const int b = row / c.nq, h = (row % c.nq) / (c.nq / c.nkv);
  const float* mp = c.m + (int64_t)row * c.splits;
  const float* lp = c.l + (int64_t)row * c.splits;
  const float* ap = c.acc + (int64_t)row * c.splits * D;
  float mx = NEG_INF;
  for (int s = 0; s < c.splits; ++s) mx = fmaxf(mx, mp[s]);
  float s0 = NEG_INF;
  if (c.mode == 2) {
    // the current token's score, reduced over the warp in a fixed order
    const __nv_bfloat16* qp = c.q + (int64_t)row * D;
    const __nv_bfloat16* kp = c.k_new + ((int64_t)b * c.nkv + h) * D;
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      t = fmaf(__bfloat162float(qp[lane + 32 * i]),
               __bfloat162float(kp[lane + 32 * i]), t);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(FULL, t, off);
    s0 = t * c.qscale;
    mx = fmaxf(mx, s0);
  }
  float o[VPL], ls = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) o[i] = 0.0f;
  for (int s = 0; s < c.splits; ++s) {
    const float sc = exp2f(mp[s] - mx);
    ls = fmaf(lp[s], sc, ls);
#pragma unroll
    for (int i = 0; i < VPL; ++i) o[i] = fmaf(ap[s * D + lane + 32 * i], sc, o[i]);
  }
  if (c.mode == 2) {
    const float wc = exp2f(s0 - mx);
    const __nv_bfloat16* vp = c.v_new + ((int64_t)b * c.nkv + h) * D;
    ls += wc;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      o[i] = fmaf(__bfloat162float(vp[lane + 32 * i]), wc, o[i]);
  }
  if (c.mode == 0) {
    float* out = static_cast<float*>(c.out) + (int64_t)row * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) out[lane + 32 * i] = o[i];
    if (lane == 0) {
      c.m_out[row] = mx > 0.5f * NEG_INF ? mx * LN2 : NEG_INF;
      c.l_out[row] = ls;
    }
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(c.out) + (int64_t)row * D;
    const float inv = 1.0f / fmaxf(ls, 1e-30f);
#pragma unroll
    for (int i = 0; i < VPL; ++i) out[lane + 32 * i] = __float2bfloat16_rn(o[i] * inv);
  }
}

// shared memory of a block: each warp's ring of `stages` columns, K rows
// then V rows
size_t ring_bytes(int d, int block, int stages) {
  return (size_t)WARPS * stages * block * 2 * d * 2;
}

using SplitKernel = void (*)(const SplitArgs);

// the instance of k4_split for (d, g), allowed SMEM_MAX of shared memory
// (set once per instance)
cudaError_t split_kernel(int d, int g, SplitKernel* kernel) {
  static const SplitKernel instances[2][4] = {
      {k4_split<64, 1>, k4_split<64, 2>, k4_split<64, 4>, k4_split<64, 8>},
      {k4_split<128, 1>, k4_split<128, 2>, k4_split<128, 4>,
       k4_split<128, 8>}};
  static bool sized[2][4] = {};
  const int i = d == 64 ? 0 : d == 128 ? 1 : -1;
  const int j = g == 1 ? 0 : g == 2 ? 1 : g == 4 ? 2 : g == 8 ? 3 : -1;
  if (i < 0 || j < 0) return cudaErrorInvalidValue;
  if (!sized[i][j]) {
    const cudaError_t err = cudaFuncSetAttribute(
        instances[i][j], cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return err;
    sized[i][j] = true;
  }
  *kernel = instances[i][j];
  return cudaSuccess;
}

bool ring_ok(int block, int stages, int d) {
  return block % 8 == 0 && block >= 8 && block <= MAX_BLOCK && stages >= 2 &&
         stages <= 4 && ring_bytes(d, block, stages) <= (size_t)SMEM_MAX;
}

}  // namespace

// Pass 1.  q, k_pool, v_pool bf16 on 16 bytes; d = dk = dv in {64, 128};
// nq / nkv in {1, 2, 4, 8}; block a multiple of 8 up to 32; pos_pool on 16
// bytes; stages in {2, 3, 4}; the partials acc (B,nq,splits,d), m and l
// (B,nq,splits) f32.  Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int k4_split_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* pos_pool,
                               const void* tables, const void* cur, void* acc,
                               void* m, void* l, int B, int nq, int nkv, int d,
                               int block, int nb, int n_blocks, int window,
                               int splits, int cols, int stages, float scale,
                               void* stream) {
  if (B < 1 || B > 65535 || nkv < 1 || nq % nkv || splits < 1 || cols < 1 ||
      !ring_ok(block, stages, d))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitKernel kernel;
  const cudaError_t err = split_kernel(d, nq / nkv, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  SplitArgs a{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k_pool),
              static_cast<const __nv_bfloat16*>(v_pool),
              static_cast<const int*>(pos_pool), static_cast<const int*>(tables),
              static_cast<const int*>(cur), static_cast<float*>(acc),
              static_cast<float*>(m), static_cast<float*>(l), nq, nkv, block,
              nb, n_blocks, window, splits, cols, stages,
              scale * 1.4426950408889634f};
  kernel<<<dim3(splits, nkv, B), THREADS, ring_bytes(d, block, stages),
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of pass 1 that one SM holds at once for (d, g = nq / nkv,
// block, stages), by cudaOccupancyMaxActiveBlocksPerMultiprocessor, into
// *per_sm: the host sizes the split grid to one wave of them.
extern "C" int k4_split_per_sm(int d, int g, int block, int stages,
                               int* per_sm) {
  if (!ring_ok(block, stages, d))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitKernel kernel;
  cudaError_t err = split_kernel(d, g, &kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, THREADS, ring_bytes(d, block, stages));
  return static_cast<int>(err);
}

// Pass 2.  mode 0: out f32 (B,nq,d) acc, m_out / l_out f32 (B,nq); mode 1:
// out bf16 acc / l; mode 2: q (B,nq,d), k_new / v_new (B,nkv,d) bf16, the
// current token folded in, out bf16.
extern "C" int k4_split_combine(const void* acc, const void* m, const void* l,
                                const void* q, const void* k_new,
                                const void* v_new, void* out, void* m_out,
                                void* l_out, int B, int nq, int nkv, int d,
                                int splits, int mode, float scale,
                                void* stream) {
  if (B < 1 || nkv < 1 || nq % nkv || splits < 1 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CombineArgs c{static_cast<const float*>(acc), static_cast<const float*>(m),
                static_cast<const float*>(l),
                static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k_new),
                static_cast<const __nv_bfloat16*>(v_new), out,
                static_cast<float*>(m_out), static_cast<float*>(l_out), B * nq,
                nq, nkv, splits, mode, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (B * nq + WARPS - 1) / WARPS;
  if (d == 64) k4_combine<64><<<grid, THREADS, 0, s>>>(c);
  else if (d == 128) k4_combine<128><<<grid, THREADS, 0, s>>>(c);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
