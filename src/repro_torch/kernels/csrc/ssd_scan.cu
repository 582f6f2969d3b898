// K5: the Mamba2 SSD chunked scan, forward and backward.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:_ssd_kernel
// (wrapper kernels/ops.py:pallas_ssd), forward only on the TPU; the
// backward here is what jax.grad of models/mamba2.py:ssd_chunked computes.
//
// Layout (the model's): xbar, y, dy (b, T, nh, P) f32; la (b, T, nh) f32;
// B, C (b, T, G, N) f32 or bf16, head h reading group h / (nh / G);
// states (b, nh, n_chunks, N, P) f32, the state at the start of each chunk.
// Per chunk of Q steps, cum = cumsum(la), tot = cum[Q-1]:
//   y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xbar_j + exp(cum_i) C_i H
//   H  <- exp(tot) H + sum_j exp(tot - cum_j) B_j^T xbar_j
// The backward's formulas are in kernels/ssd_scan.py:ssd_scan_bwd_plain.
//
// Bound on an H100: bytes (xbar in and y out in f32 are most of them; the
// ~26 GFLOP of a training-shape forward take 0.026 ms at the bf16 peak).
//
// Design (chunk-parallel, the structure of the Mamba2 SSD kernels of
// arXiv:2405.21060 sections 7-8).  The recurrence above holds for any
// split of a chunk, so the kernels cut every chunk into sub-chunks of
// L = 64 steps (the last one shorter when 64 does not divide Q) and carry
// the state from sub-chunk to sub-chunk: what the chunk's sub-blocks below
// the diagonal would add is the carried state's term of the later
// sub-chunks.  That halves the products of a 256-step chunk, and every
// product is one 64 x 64 x 64 tile.  The forward runs three passes:
//   1. ssd_state: one block per (sub-chunk, head, batch), in parallel,
//      computes the sub-chunk's own state S = sum_j exp(tot - cum_j)
//      B_j^T xbar_j and its decay exp(tot);
//   2. ssd_pass: a short sequential pass over the sub-chunks of each
//      (batch, head), parallel over the N x P entries, replaces each S by
//      the state H at its sub-chunk's start (H <- exp(tot) H + S) and
//      writes `states` at every chunk's start;
//   3. ssd_out: one block per (sub-chunk, head, batch) computes
//      y = exp(cum) (C H) + ((C B^T) * L) xbar, L_ij = exp(cum_i - cum_j)
//      formed only where i >= j.  C B^T is the same for every head of a
//      group, so ssd_cb forms it once per (sub-chunk, group, batch).
// The backward repeats passes 1 and 2 from `states` (H at each
// sub-chunk's start) and, in the same kernels, builds dH in reverse: pass
// 1 also computes each sub-chunk's sum_i exp(cum_i) C_i^T dy_i, and pass 2
// carries dH <- exp(tot) dH + that sum backwards over every sub-chunk.
// Then ssd_bwd_sub, one block per (sub-chunk, head, batch), computes
// dxbar, dla (a reverse scan inside the sub-chunk) and the per-head dB and
// dC from H and the dH after the sub-chunk; group_sum adds the heads of
// each group in head order.  No atomics anywhere: the same inputs give the
// same bits.
//
// Products: f32 FMA on CUDA cores (a TF32 mma reads ~1e-3 off, and the
// kernels are held to 1e-4).  A block of 128 threads computes a 64 x 64
// tile, each thread an 8 x 4 register tile (rows 8 tm + a, columns
// tn + 16 b), its operands read from shared memory mostly as 16-byte
// vectors: 4-8 wavefronts a warp for 32 FMA a thread, against 8 for 16
// in a 4 x 4 tile read float by float (see mm).  Tiles sit in shared
// memory as [row][col] with rows padded to 68 floats (16-byte aligned,
// and rows 1 apart on other banks).  f32 tiles arrive by cp.async, all of
// a block's loads in flight at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int L = 64;                  // sub-chunk rows; N, P <= L
constexpr int LD = L + 4;              // padded row stride of a tile
constexpr int TILE_FLOATS = L * LD;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The sub-chunk a block handles: blockIdx.x = chunk * nsc + sub, y = head,
// z = batch.
struct Sub {
  int b, h, g, c, s, len;   // s: index over every sub-chunk of the sequence
  int64_t t0;               // first row, counted over b * T
  __device__ Sub(int Tn, int nh, int G, int Q) {
    const int nsc = (Q + L - 1) / L;
    s = blockIdx.x;
    c = s / nsc;
    const int i0 = (s % nsc) * L;
    len = min(L, Q - i0);
    h = blockIdx.y;
    b = blockIdx.z;
    g = h / (nh / G);
    t0 = (int64_t)b * Tn + (int64_t)c * Q + i0;
  }
};

// Tiles reach shared memory as t[r][c] = src[r * stride + c] for
// r < nrows, c < ncols, zero elsewhere in the 64 x 64 tile, consecutive
// threads on consecutive columns.  f32 sources go by cp.async (every load
// of a block in flight at once, no registers held); bf16 ones through
// registers, PER elements a thread (a load straight into shared memory
// would wait for the one before: the compiler cannot tell the two
// pointers apart).  landed() waits for both kinds.
constexpr int PER = L * L / THREADS;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d),
               "l"(src) : "memory");
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int nrows,
                                          int ncols) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 8
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int r = e >> 6, c = e & (L - 1);
      if (r < nrows && c < ncols)
        cp_async4(dst + r * LD + c, src + (int64_t)r * stride + c);
      else
        dst[r * LD + c] = 0.0f;
    }
  } else {
    float v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int r = e >> 6, c = e & (L - 1);
      v[k] = r < nrows && c < ncols ? to_f(src[(int64_t)r * stride + c])
                                    : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * THREADS;
      dst[(e >> 6) * LD + (e & (L - 1))] = v[k];
    }
  }
}

// every load_tile of this thread has landed, and (the barrier) every
// other thread's too
__device__ __forceinline__ void landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// acc[a][b] += sum_{k < K} A(k, 8 tm + a) * B(k, tn + 16 b): a thread's
// rows are 8 in a row, its columns 16 apart.  A_ROWS: A(k, m) = As[m LD
// + k], else As[k LD + m]; the same for B and B_ROWS.  K is rounded up to
// a multiple of 4 (the tiles are zero past K): four steps of k a round,
// A's fragment read as 16-byte vectors (over k for A_ROWS, over the 8
// rows otherwise), B's over k for B_ROWS and as single floats otherwise,
// so that a round reads 4-8 shared-memory wavefronts a warp for 32 FMA a
// thread, against 12 for a 4 x 4 tile read float by float.
template <bool A_ROWS, bool B_ROWS>
__device__ __forceinline__ void mm(float (&acc)[8][4], const float* As,
                                   const float* Bs, int K, int tm, int tn) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 4) {
    float a[4][8], b[4][4];
#pragma unroll
    for (int i = 0; i < 8; i += A_ROWS ? 1 : 4) {
      if (A_ROWS) {
        const float4 v =
            *reinterpret_cast<const float4*>(As + (8 * tm + i) * LD + k0);
        a[0][i] = v.x; a[1][i] = v.y; a[2][i] = v.z; a[3][i] = v.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + (k0 + kk) * LD + 8 * tm + i);
          a[kk][i] = v.x; a[kk][i + 1] = v.y; a[kk][i + 2] = v.z;
          a[kk][i + 3] = v.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (B_ROWS) {
        const float4 v =
            *reinterpret_cast<const float4*>(Bs + (tn + 16 * j) * LD + k0);
        b[0][j] = v.x; b[1][j] = v.y; b[2][j] = v.z; b[3][j] = v.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) b[kk][j] = Bs[(k0 + kk) * LD + tn + 16 * j];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[kk][i], b[kk][j], acc[i][j]);
  }
}

// the operand forms: a tile T[r][c] read as A(k = c, m = r) ("rows"), or
// as A(k = r, m = c) ("cols"); the same for B
constexpr bool ROWS = true, COLS = false;

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// Sum over the 16 lanes of a half warp (the tn of one tm).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cum[k] = la[0] + ... + la[k] for k < len (la strided by `stride`), then
// ecum[k] = exp(cum[k]) and w[k] = exp(tot - cum[k]), zero for k >= len;
// returns tot.  Warp 0 scans 32 steps at a time with shuffles (a fixed
// order).  Ends with __syncthreads().
__device__ float decays(const float* la, int64_t stride, int len, float* cum,
                        float* ecum, float* w) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.0f;
    for (int base = 0; base < len; base += 32) {
      const int i = base + lane;
      float v = i < len ? la[(int64_t)i * stride] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (i < len) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float tot = cum[len - 1];
  for (int k = threadIdx.x; k < L; k += THREADS) {
    const bool in = k < len;
    ecum[k] = in ? expf(cum[k]) : 0.0f;
    w[k] = in ? expf(tot - cum[k]) : 0.0f;
    if (!in) cum[k] = tot;
  }
  __syncthreads();
  return tot;
}

// out[n * P + p] = acc (rows n < N, columns p < P)
__device__ __forceinline__ void store_np(float* out, const float (&acc)[8][4],
                                         int N, int P, int tm, int tn) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = 8 * tm + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tn + 16 * j;
      if (p < P) out[n * P + p] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 1: the sub-chunk's own state S = sum_j w_j B_j^T xbar_j and its decay
// exp(tot); with BWD also U = sum_i ecum_i C_i^T dy_i.  S, U: (b, nh, nsub,
// N, P); decay: (b, nh, nsub).
// ---------------------------------------------------------------------------
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
ssd_state(const float* __restrict__ xbar, const float* __restrict__ la,
          const T* __restrict__ Bm, const T* __restrict__ Cm,
          const float* __restrict__ dy, float* __restrict__ S,
          float* __restrict__ U, float* __restrict__ decay, int Tn, int nh,
          int P, int G, int N, int Q) {
  extern __shared__ float sm[];
  float* sB = sm;
  float* sX = sB + TILE_FLOATS;
  float* sC = sX + TILE_FLOATS;         // BWD only
  float* sDY = sC + TILE_FLOATS;        // BWD only
  __shared__ float cum[L], ecum[L], wv[L];
  const Sub q(Tn, nh, G, Q);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int64_t xs = (int64_t)nh * P, bs = (int64_t)G * N;
  load_tile(sB, Bm + q.t0 * bs + (int64_t)q.g * N, bs, q.len, N);
  load_tile(sX, xbar + q.t0 * xs + (int64_t)q.h * P, xs, q.len, P);
  if (BWD) {
    load_tile(sC, Cm + q.t0 * bs + (int64_t)q.g * N, bs, q.len, N);
    load_tile(sDY, dy + q.t0 * xs + (int64_t)q.h * P, xs, q.len, P);
  }
  landed();
  const float tot = decays(la + q.t0 * nh + q.h, nh, q.len, cum, ecum, wv);
  const int64_t slot = ((int64_t)q.b * nh + q.h) * gridDim.x + q.s;
  if (threadIdx.x == 0) decay[slot] = expf(tot);
  // scale row j of B by w_j (and row i of C by ecum_i)
  for (int e = threadIdx.x; e < L * L; e += THREADS) {
    const int r = e >> 6, c = e & (L - 1);
    sB[r * LD + c] *= wv[r];
    if (BWD) sC[r * LD + c] *= ecum[r];
  }
  __syncthreads();
  float acc[8][4];
  zero(acc);
  mm<COLS, COLS>(acc, sB, sX, q.len, tm, tn);     // (n, p), k = j
  store_np(S + slot * N * P, acc, N, P, tm, tn);
  if (BWD) {
    zero(acc);
    mm<COLS, COLS>(acc, sC, sDY, q.len, tm, tn);
    store_np(U + slot * N * P, acc, N, P, tm, tn);
  }
}

// ---------------------------------------------------------------------------
// Pass 2, one thread per entry (n, p) of one (batch, head).  Forward: walks
// the sub-chunks in order, replacing S by the state at the sub-chunk's
// start and writing `states` at each chunk's start.  Backward: the blocks
// of the first half of blockIdx.x do the same from `states` (the state
// restarts from it at every chunk); those of the second half replace U by
// dH after the sub-chunk, walking in reverse.  Loads go ahead in runs of
// RUN sub-chunks, so that each thread keeps several in flight.
// ---------------------------------------------------------------------------
constexpr int RUN = 32;

template <bool BWD>
__global__ void __launch_bounds__(THREADS)
ssd_pass(float* __restrict__ S, float* __restrict__ U,
         const float* __restrict__ decay, float* __restrict__ states,
         int nsub, int nsc, int NP) {
  const int half = BWD ? gridDim.x / 2 : gridDim.x;
  const bool reverse = blockIdx.x >= half;
  const int e = (blockIdx.x - (reverse ? half : 0)) * THREADS + threadIdx.x;
  if (e >= NP) return;
  const int64_t bh = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  const float* a = decay + bh * nsub;
  if (!reverse) {
    float* Sb = S + bh * nsub * NP + e;
    float* st = states + bh * (nsub / nsc) * NP + e;
    float h = 0.0f;
    for (int s0 = 0; s0 < nsub; s0 += RUN) {
      float v[RUN];
#pragma unroll
      for (int u = 0; u < RUN; ++u)
        if (s0 + u < nsub) v[u] = Sb[(int64_t)(s0 + u) * NP];
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        const int s = s0 + u;
        if (s >= nsub) break;
        if (s % nsc == 0) {
          if (BWD) h = st[(int64_t)(s / nsc) * NP];
          else st[(int64_t)(s / nsc) * NP] = h;
        }
        Sb[(int64_t)s * NP] = h;
        h = a[s] * h + v[u];
      }
    }
    return;
  }
  float* Ub = U + bh * nsub * NP + e;
  float gd = 0.0f;
  for (int s0 = nsub - 1; s0 >= 0; s0 -= RUN) {
    float v[RUN];
#pragma unroll
    for (int u = 0; u < RUN; ++u)
      if (s0 - u >= 0) v[u] = Ub[(int64_t)(s0 - u) * NP];
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      const int s = s0 - u;
      if (s < 0) break;
      Ub[(int64_t)s * NP] = gd;
      gd = a[s] * gd + v[u];
    }
  }
}

// ---------------------------------------------------------------------------
// C B^T of each sub-chunk and group, (b, G, nsub, 64, 64): the same for
// every head of the group, so it is formed once and read by each head's
// ssd_out and ssd_bwd_sub.  blockIdx.y is the group here.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
       float* __restrict__ cb, int Tn, int G, int N, int Q) {
  extern __shared__ float sm[];
  float* sC = sm;
  float* sB = sC + TILE_FLOATS;
  const Sub q(Tn, G, G, Q);            // one "head" per group
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int64_t bs = (int64_t)G * N;
  load_tile(sC, Cm + q.t0 * bs + (int64_t)q.g * N, bs, q.len, N);
  load_tile(sB, Bm + q.t0 * bs + (int64_t)q.g * N, bs, q.len, N);
  landed();
  float acc[8][4];
  zero(acc);
  mm<ROWS, ROWS>(acc, sC, sB, N, tm, tn);         // (i, j), k = n
  store_np(cb + (((int64_t)q.b * G + q.g) * gridDim.x + q.s) * L * L, acc,
           L, L, tm, tn);
}

// S[r][c] = CB[r][c] exp(cum_r - cum_c) where r >= c and r < len, else 0,
// in place: the exponent only where allowed, never exp of a positive gap
__device__ __forceinline__ void decay_mask(float* sS, const float* cum,
                                           int len) {
  for (int e = threadIdx.x; e < L * L; e += THREADS) {
    const int r = e >> 6, c = e & (L - 1);
    const int o = r * LD + c;
    sS[o] = r >= c && r < len ? sS[o] * expf(cum[r] - cum[c]) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Pass 3 of the forward: y = exp(cum) (C H) + ((C B^T) * L) xbar.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_out(const float* __restrict__ xbar, const float* __restrict__ la,
        const T* __restrict__ Cm, const float* __restrict__ cb,
        const float* __restrict__ Hs, float* __restrict__ y, int Tn, int nh,
        int P, int G, int N, int Q) {
  extern __shared__ float sm[];
  float* sC = sm;
  float* sH = sC + TILE_FLOATS;
  float* sS = sH + TILE_FLOATS;          // C B^T, then S = (C B^T) * L
  float* sX = sS + TILE_FLOATS;
  __shared__ float cum[L], ecum[L], wv[L];
  const Sub q(Tn, nh, G, Q);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int64_t xs = (int64_t)nh * P, bs = (int64_t)G * N;
  const int64_t slot = ((int64_t)q.b * nh + q.h) * gridDim.x + q.s;
  load_tile(sC, Cm + q.t0 * bs + (int64_t)q.g * N, bs, q.len, N);
  load_tile(sH, Hs + slot * N * P, P, N, P);
  load_tile(sS, cb + (((int64_t)q.b * G + q.g) * gridDim.x + q.s) * L * L,
            L, L, L);
  load_tile(sX, xbar + q.t0 * xs + (int64_t)q.h * P, xs, q.len, P);
  landed();
  decays(la + q.t0 * nh + q.h, nh, q.len, cum, ecum, wv);
  decay_mask(sS, cum, q.len);
  __syncthreads();
  float yacc[8][4];
  zero(yacc);
  mm<ROWS, COLS>(yacc, sC, sH, N, tm, tn);        // (i, p), k = n
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) yacc[i][j] *= ecum[8 * tm + i];
  mm<ROWS, COLS>(yacc, sS, sX, q.len, tm, tn);    // (i, p), k = j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tm + i;
    if (r >= q.len) continue;
    float* yr = y + (q.t0 + r) * xs + (int64_t)q.h * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tn + 16 * j;
      if (p < P) yr[p] = yacc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The backward of one sub-chunk, from H at its start and dH (G) after it:
//   S = (C B^T) * L, dS = dy xbar^T, D = dS * L, M = S * dS
//   dxbar = S^T dy + w (B G)
//   dC    = D B + ecum (dy H^T),           r_i = C_i . ecum_i (H dy_i)
//   dB    = D^T C + w (xbar G^T),          q_j = B_j . w_j (G xbar_j)
//   dcum  = rowsum(M) - colsum(M) + r - q
//   dtot  = sum q + exp(tot) <H, G>,       dla_m = sum_{k>=m} dcum_k + dtot
// dB, dC per head into dBh, dCh (b, T, nh, N).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_sub(const float* __restrict__ dy, const float* __restrict__ xbar,
            const float* __restrict__ la, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ cb,
            const float* __restrict__ Hs, const float* __restrict__ Gs,
            float* __restrict__ dx, float* __restrict__ dla,
            float* __restrict__ dBh, float* __restrict__ dCh, int Tn, int nh,
            int P, int G, int N, int Q) {
  extern __shared__ float sm[];
  float* sC = sm;
  float* sB = sC + TILE_FLOATS;
  float* sX = sB + TILE_FLOATS;          // xbar[j][p], then D[i][j]
  float* sDY = sX + TILE_FLOATS;
  float* sT = sDY + TILE_FLOATS;         // H[n][p], then G[n][p]
  float* sS = sT + TILE_FLOATS;          // C B^T, then S[i][j]
  __shared__ float cum[L], ecum[L], wv[L];
  __shared__ float rowm[L], colm[L], rq[L], qv[L];
  __shared__ float colpart[8][L];
  __shared__ float red[THREADS / 32];
  const Sub q(Tn, nh, G, Q);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int64_t xs = (int64_t)nh * P, bs = (int64_t)G * N;
  const int64_t hs = (int64_t)nh * N;    // row stride of dBh, dCh
  const int64_t slot = ((int64_t)q.b * nh + q.h) * gridDim.x + q.s;
  load_tile(sC, Cm + q.t0 * bs + (int64_t)q.g * N, bs, q.len, N);
  load_tile(sB, Bm + q.t0 * bs + (int64_t)q.g * N, bs, q.len, N);
  load_tile(sX, xbar + q.t0 * xs + (int64_t)q.h * P, xs, q.len, P);
  load_tile(sDY, dy + q.t0 * xs + (int64_t)q.h * P, xs, q.len, P);
  load_tile(sT, Hs + slot * N * P, P, N, P);
  load_tile(sS, cb + (((int64_t)q.b * G + q.g) * gridDim.x + q.s) * L * L,
            L, L, L);
  landed();
  const float tot = decays(la + q.t0 * nh + q.h, nh, q.len, cum, ecum, wv);
  decay_mask(sS, cum, q.len);

  // dC's carried-state part, (i, n), k = p; and r_i
  float dc[8][4];
  zero(dc);
  mm<ROWS, ROWS>(dc, sDY, sT, P, tm, tn);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tm + i;
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dc[i][j] *= ecum[r];
      t = fmaf(sC[r * LD + tn + 16 * j], dc[i][j], t);
    }
    t = half_warp_sum(t);
    if (tn == 0) rq[r] = t;
  }
  __syncthreads();                       // every read of H is done
  // G replaces H; <H, G> on the way
  float hg = 0.0f;
  {
    const float* src = Gs + slot * N * P;
    float gv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int r = e >> 6, c = e & (L - 1);
      gv[k] = r < N && c < P ? src[r * P + c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int o = (e >> 6) * LD + (e & (L - 1));
      hg = fmaf(sT[o], gv[k], hg);
      sT[o] = gv[k];
    }
  }
  __syncthreads();
  // dB's carried-state part, (j, n), k = p; and q_j
  float db[8][4];
  zero(db);
  mm<ROWS, ROWS>(db, sX, sT, P, tm, tn);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tm + i;
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      db[i][j] *= wv[r];
      t = fmaf(sB[r * LD + tn + 16 * j], db[i][j], t);
    }
    t = half_warp_sum(t);
    if (tn == 0) qv[r] = t;
  }
  // dxbar's carried-state part, (j, p), k = n
  float dxa[8][4];
  zero(dxa);
  mm<ROWS, COLS>(dxa, sB, sT, N, tm, tn);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dxa[i][j] *= wv[8 * tm + i];
  // dS, (i, j)
  float ds[8][4];
  zero(ds);
  mm<ROWS, ROWS>(ds, sDY, sX, P, tm, tn);
  __syncthreads();                       // every read of xbar is done
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tm + i;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tn + 16 * j;
      float dl = 0.0f, mv = 0.0f;
      if (r >= c && r < q.len) {         // the exponent only where allowed
        dl = ds[i][j] * expf(cum[r] - cum[c]);
        mv = sS[r * LD + c] * ds[i][j];
      }
      sX[r * LD + c] = dl;
      rs += mv;
      ds[i][j] = mv;                     // M, for the column sums
    }
    rs = half_warp_sum(rs);
    if (tn == 0) rowm[r] = rs;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float cs = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) cs += ds[i][j];
    colpart[tm][tn + 16 * j] = cs;
  }
  __syncthreads();
  if (threadIdx.x < L) {
    float cs = 0.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) cs += colpart[t][threadIdx.x];
    colm[threadIdx.x] = cs;
  }
  mm<COLS, COLS>(dxa, sS, sDY, q.len, tm, tn);   // += S^T dy, k = i
  mm<ROWS, COLS>(dc, sX, sB, q.len, tm, tn);     // += D B, k = j
  mm<COLS, COLS>(db, sX, sC, q.len, tm, tn);     // += D^T C, k = i
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tm + i;
    if (r >= q.len) continue;
    float* xr = dx + (q.t0 + r) * xs + (int64_t)q.h * P;
    float* cr = dCh + (q.t0 + r) * hs + (int64_t)q.h * N;
    float* br = dBh + (q.t0 + r) * hs + (int64_t)q.h * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tn + 16 * j;
      if (c < P) xr[c] = dxa[i][j];
      if (c < N) {
        cr[c] = dc[i][j];
        br[c] = db[i][j];
      }
    }
  }
  // dtot = sum_k q_k + exp(tot) <H, G>, in a fixed order
  float part = hg * expf(tot);
  if (threadIdx.x < L && threadIdx.x < q.len) part += qv[threadIdx.x];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();                       // colm, red complete
  if (threadIdx.x < 32) {
    float dtot = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) dtot += red[w];
    // dla_m = sum_{k >= m} dcum_k + dtot: a scan from the sub-chunk's end
    const int lane = threadIdx.x;
    float carry = dtot;
    for (int base = 0; base < q.len; base += 32) {
      const int k = q.len - 1 - (base + lane);
      float v = k >= 0 ? rowm[k] - colm[k] + rq[k] - qv[k] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (k >= 0) dla[(q.t0 + k) * nh + q.h] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// dB[row, g, n] = sum over the group's heads r of dBh[row, g * rep + r, n],
// in head order; the same for dC (the second half of the index range).
template <typename T>
__global__ void group_sum(const float* __restrict__ dBh,
                          const float* __restrict__ dCh, T* __restrict__ dB,
                          T* __restrict__ dC, int64_t per, int G, int rep,
                          int N) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * per) return;
  const bool isB = e < per;
  const int64_t o = isB ? e : e - per;
  const int n = (int)(o % N);
  const int64_t rg = o / N;
  const int gg = (int)(rg % G);
  const int64_t row = rg / G;
  const float* src = (isB ? dBh : dCh) + (row * G * rep + (int64_t)gg * rep) * N + n;
  float s = 0.0f;
  for (int r = 0; r < rep; ++r) s += src[(int64_t)r * N];
  (isB ? dB : dC)[o] = from_f<T>(s);
}

// launches kernel on `grid` with `tiles` tiles of dynamic shared memory
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int tiles, cudaStream_t s,
           Args... args) {
  const size_t smem = (size_t)tiles * TILE_FLOATS * sizeof(float);
  if (smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

struct Shape {
  int batch, Tn, nh, P, G, N, Q, nsc, nsub;
  Shape(int batch_, int Tn_, int nh_, int P_, int G_, int N_, int Q_)
      : batch(batch_), Tn(Tn_), nh(nh_), P(P_), G(G_), N(N_), Q(Q_),
        nsc((Q_ + L - 1) / L), nsub(Tn_ / Q_ * ((Q_ + L - 1) / L)) {}
  dim3 subs() const { return dim3(nsub, nh, batch); }
  // ssd_pass's grid: blocks over the N x P entries (twice for the
  // backward: forward in time and in reverse)
  dim3 entries(bool bwd) const {
    return dim3((N * P + THREADS - 1) / THREADS * (bwd ? 2 : 1), nh, batch);
  }
};

template <typename T>
int fwd(const float* xbar, const float* la, const T* B, const T* C, float* y,
        float* states, float* S, float* cb, float* decay, const Shape& z,
        cudaStream_t s) {
  const float* none = nullptr;
  int err = launch(ssd_state<T, false>, z.subs(), 2, s, xbar, la, B, C, none,
                   S, (float*)nullptr, decay, z.Tn, z.nh, z.P, z.G, z.N,
                   z.Q);
  if (err != 0) return err;
  err = launch(ssd_cb<T>, dim3(z.nsub, z.G, z.batch), 2, s, B, C, cb, z.Tn,
               z.G, z.N, z.Q);
  if (err != 0) return err;
  err = launch(ssd_pass<false>, z.entries(false), 0, s, S, (float*)nullptr,
               (const float*)decay, states, z.nsub, z.nsc, z.N * z.P);
  if (err != 0) return err;
  return launch(ssd_out<T>, z.subs(), 4, s, xbar, la, C, (const float*)cb,
                (const float*)S, y, z.Tn, z.nh, z.P, z.G, z.N, z.Q);
}

template <typename T>
int bwd(const float* dy, const float* xbar, const float* la, const T* B,
        const T* C, float* states, float* dx, float* dla, float* dBh,
        float* dCh, T* dB, T* dC, float* S, float* U, float* cb,
        float* decay, const Shape& z, cudaStream_t s) {
  int err = launch(ssd_state<T, true>, z.subs(), 4, s, xbar, la, B, C, dy, S,
                   U, decay, z.Tn, z.nh, z.P, z.G, z.N, z.Q);
  if (err != 0) return err;
  err = launch(ssd_cb<T>, dim3(z.nsub, z.G, z.batch), 2, s, B, C, cb, z.Tn,
               z.G, z.N, z.Q);
  if (err != 0) return err;
  err = launch(ssd_pass<true>, z.entries(true), 0, s, S, U, (const float*)decay,
               states, z.nsub, z.nsc, z.N * z.P);
  if (err != 0) return err;
  err = launch(ssd_bwd_sub<T>, z.subs(), 6, s, dy, xbar, la, B, C,
               (const float*)cb, (const float*)S, (const float*)U, dx, dla,
               dBh, dCh, z.Tn, z.nh, z.P, z.G, z.N, z.Q);
  if (err != 0) return err;
  const int64_t per = (int64_t)z.batch * z.Tn * z.G * z.N;
  const int64_t blocks = (2 * per + 255) / 256;
  group_sum<T><<<(unsigned)blocks, 256, 0, s>>>(dBh, dCh, dB, dC, per, z.G,
                                                z.nh / z.G, z.N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S, U: float32 (b, nh, nsub, N, P) scratch, cb float32 (b, G, nsub, 64,
// 64) and decay float32 (b, nh, nsub), nsub = (T / Q) * ceil(Q / 64).
// dtype: 0 float32, 1 bfloat16 (of B and C).  Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int k5_ssd_fwd(const void* xbar, const void* la, const void* B,
                          const void* C, void* y, void* states, void* S,
                          void* cb, void* decay, int batch, int Tn, int nh,
                          int P, int G, int N, int Q, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape z(batch, Tn, nh, P, G, N, Q);
  const float* x = static_cast<const float*>(xbar);
  const float* a = static_cast<const float*>(la);
  float* yo = static_cast<float*>(y);
  float* st = static_cast<float*>(states);
  float* sb = static_cast<float*>(S);
  float* cbp = static_cast<float*>(cb);
  float* dc = static_cast<float*>(decay);
  if (dtype == 0)
    return fwd<float>(x, a, static_cast<const float*>(B),
                      static_cast<const float*>(C), yo, st, sb, cbp, dc, z,
                      s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, a, static_cast<const __nv_bfloat16*>(B),
                              static_cast<const __nv_bfloat16*>(C), yo, st,
                              sb, cbp, dc, z, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dBh, dCh: float32 (b, T, nh, N) scratch for the per-head partials; S, U,
// cb, decay as for the forward.
extern "C" int k5_ssd_bwd(const void* dy, const void* xbar, const void* la,
                          const void* B, const void* C, const void* states,
                          void* dx, void* dla, void* dBh, void* dCh, void* dB,
                          void* dC, void* S, void* U, void* cb, void* decay,
                          int batch, int Tn, int nh, int P, int G, int N,
                          int Q, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape z(batch, Tn, nh, P, G, N, Q);
  const float* d = static_cast<const float*>(dy);
  const float* x = static_cast<const float*>(xbar);
  const float* a = static_cast<const float*>(la);
  float* st = const_cast<float*>(static_cast<const float*>(states));
  float* dxo = static_cast<float*>(dx);
  float* dlo = static_cast<float*>(dla);
  float* bh = static_cast<float*>(dBh);
  float* ch = static_cast<float*>(dCh);
  float* sb = static_cast<float*>(S);
  float* ub = static_cast<float*>(U);
  float* cbp = static_cast<float*>(cb);
  float* dc = static_cast<float*>(decay);
  if (dtype == 0)
    return bwd<float>(d, x, a, static_cast<const float*>(B),
                      static_cast<const float*>(C), st, dxo, dlo, bh, ch,
                      static_cast<float*>(dB), static_cast<float*>(dC), sb,
                      ub, cbp, dc, z, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(
        d, x, a, static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), st, dxo, dlo, bh, ch,
        static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC), sb,
        ub, cbp, dc, z, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
