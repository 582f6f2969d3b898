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
// Design: one 256-thread block per (head, batch) walks the chunks in order
// (the backward in reverse), carrying the state H (or dH) in shared memory.
// A chunk is cut into 64-row sub-blocks; for the row block I and each
// column block J <= I, 64 x 64 f32 tiles sit in shared memory with rows
// padded to 65 floats (the strided column reads are free of bank
// conflicts), and each thread owns a 4 x 4 register tile: rows ty + 16a,
// columns tx + 16b.  exp(cum_i - cum_j) is formed only where i >= j and
// both rows lie in the chunk: above the diagonal it overflows to inf, and
// inf * 0 is NaN in the backward.  The backward accumulates dxbar and the
// per-head dB in global memory, each element always by the same thread in
// a fixed order, and a second kernel sums the per-head dB and dC over the
// heads of each group in head order: no atomics anywhere, so the same
// inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;               // sub-block rows; N, P <= TILE
constexpr int LD = TILE + 1;           // padded row stride of a tile
constexpr int TILE_FLOATS = TILE * LD;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dst[r][c] = src[r * stride + c] for r < nrows, c < ncols; zero elsewhere
// in the 64 x 64 tile.  Consecutive threads read consecutive columns.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int nrows,
                                          int ncols) {
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e >> 6, c = e & (TILE - 1);
    float v = 0.0f;
    if (r < nrows && c < ncols) v = to_f(src[(int64_t)r * stride + c]);
    dst[r * LD + c] = v;
  }
}

// cum[k] = la[0] + ... + la[k] for k < Q (la strided by `stride`), then
// ecum[k] = exp(cum[k]) and w[k] = exp(tot - cum[k]); zero past Q up to
// qpad.  Warp 0 scans 32 steps at a time with shuffles (a fixed order).
// Ends with __syncthreads().
__device__ void chunk_decays(const float* la, int64_t stride, int Q,
                             int qpad, float* cum, float* ecum, float* w) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.0f;
    for (int base = 0; base < Q; base += 32) {
      const int i = base + lane;
      float v = i < Q ? la[(int64_t)i * stride] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (i < Q) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float tot = cum[Q - 1];
  for (int k = threadIdx.x; k < qpad; k += THREADS) {
    const bool in = k < Q;
    if (!in) cum[k] = tot;
    ecum[k] = in ? expf(cum[k]) : 0.0f;
    w[k] = in ? expf(tot - cum[k]) : 0.0f;
  }
  __syncthreads();
}

// Sum of v over the block, the same on every thread, in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) t += red[i];
  return t;
}

// Sum over the 16 lanes of a half warp (the tx of one ty).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Forward.  Shared memory: C_I, B_J, X_J, S, H tiles, then cum, ecum, w.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const float* __restrict__ xbar, const float* __restrict__ la,
        const T* __restrict__ Bm, const T* __restrict__ Cm,
        float* __restrict__ y, float* __restrict__ states, int Tn, int nh,
        int P, int G, int N, int Q) {
  extern __shared__ float sm[];
  const int nsub = (Q + TILE - 1) / TILE, qpad = nsub * TILE;
  float* sC = sm;
  float* sB = sC + TILE_FLOATS;
  float* sX = sB + TILE_FLOATS;
  float* sS = sX + TILE_FLOATS;
  float* sH = sS + TILE_FLOATS;          // H[n][p]
  float* cum = sH + TILE_FLOATS;
  float* ecum = cum + qpad;
  float* wv = ecum + qpad;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nc = Tn / Q;
  const int64_t xs = (int64_t)nh * P, bs = (int64_t)G * N;

  for (int e = threadIdx.x; e < TILE_FLOATS; e += THREADS) sH[e] = 0.0f;
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const int64_t t0 = (int64_t)b * Tn + (int64_t)c * Q;
    {
      float* st = states + (((int64_t)b * nh + h) * nc + c) * N * P;
      for (int e = threadIdx.x; e < N * P; e += THREADS)
        st[e] = sH[(e / P) * LD + e % P];
    }
    chunk_decays(la + t0 * nh + h, nh, Q, qpad, cum, ecum, wv);
    const float etot = expf(cum[Q - 1]);

    float hacc[4][4];                  // the next state, rows n, cols p
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        hacc[a][bb] = etot * sH[(ty + 16 * a) * LD + tx + 16 * bb];

    for (int I = 0; I < nsub; ++I) {
      const int i0 = I * TILE, ni = min(TILE, Q - i0);
      __syncthreads();                 // sC is free
      load_tile(sC, Cm + (t0 + i0) * bs + (int64_t)g * N, bs, ni, N);
      __syncthreads();

      // carried state: y_i = exp(cum_i) C_i H
      float yacc[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float cv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * LD + k];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) hv[bb] = sH[k * LD + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) yacc[a][bb] = fmaf(cv[a], hv[bb], yacc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = ecum[i0 + ty + 16 * a];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) yacc[a][bb] *= e;
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * TILE, nj = min(TILE, Q - j0);
        __syncthreads();               // sB, sX, sS are free
        load_tile(sB, Bm + (t0 + j0) * bs + (int64_t)g * N, bs, nj, N);
        load_tile(sX, xbar + (t0 + j0) * xs + (int64_t)h * P, xs, nj, P);
        __syncthreads();
        float s[4][4] = {};
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * LD + k];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) bv[bb] = sB[(tx + 16 * bb) * LD + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) s[a][bb] = fmaf(cv[a], bv[bb], s[a][bb]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int j = tx + 16 * bb;
            const bool ok = i0 + i >= j0 + j && i < ni && j < nj;
            // the exponent only where allowed: never exp of a positive gap
            sS[i * LD + j] = ok ? s[a][bb] * expf(cum[i0 + i] - cum[j0 + j])
                                : 0.0f;
          }
        }
        __syncthreads();
        for (int k = 0; k < nj; ++k) {
          float sv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = sS[(ty + 16 * a) * LD + k];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) xv[bb] = sX[k * LD + tx + 16 * bb];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) yacc[a][bb] = fmaf(sv[a], xv[bb], yacc[a][bb]);
        }
      }

      // sB and sX hold block I: its share of the next state
      for (int k = 0; k < ni; ++k) {
        const float wk = wv[i0 + k];
        float bv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = wk * sB[k * LD + ty + 16 * a];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) xv[bb] = sX[k * LD + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) hacc[a][bb] = fmaf(bv[a], xv[bb], hacc[a][bb]);
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= ni) continue;
        float* yr = y + (t0 + i0 + i) * xs + (int64_t)h * P;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int p = tx + 16 * bb;
          if (p < P) yr[p] = yacc[a][bb];
        }
      }
    }
    __syncthreads();                   // every read of the old H is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        sH[(ty + 16 * a) * LD + tx + 16 * bb] = hacc[a][bb];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Backward.  Shared memory: C_I, dY_I, B_J, X_J, S, dS*L, S*dS, dH, H
// tiles, then cum, ecum, w, rowpart, colpart, r, q.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd(const float* __restrict__ dy, const float* __restrict__ xbar,
        const float* __restrict__ la, const T* __restrict__ Bm,
        const T* __restrict__ Cm, const float* __restrict__ states,
        float* __restrict__ dx, float* __restrict__ dla,
        float* __restrict__ dBh, float* __restrict__ dCh, int Tn, int nh,
        int P, int G, int N, int Q) {
  extern __shared__ float sm[];
  __shared__ float red[WARPS];
  const int nsub = (Q + TILE - 1) / TILE, qpad = nsub * TILE;
  float* sC = sm;
  float* sDY = sC + TILE_FLOATS;
  float* sB = sDY + TILE_FLOATS;
  float* sX = sB + TILE_FLOATS;
  float* sS = sX + TILE_FLOATS;        // S = (C B^T) * L
  float* sD = sS + TILE_FLOATS;        // dS * L
  float* sM = sD + TILE_FLOATS;        // S * dS
  float* sG = sM + TILE_FLOATS;        // dH[n][p] after this chunk
  float* sH = sG + TILE_FLOATS;        // H[n][p] at the chunk's start
  float* cum = sH + TILE_FLOATS;
  float* ecum = cum + qpad;
  float* wv = ecum + qpad;
  float* rowpart = wv + qpad;          // sum_j M_kj
  float* colpart = rowpart + qpad;     // sum_i M_ik
  float* rbuf = colpart + qpad;        // exp(cum_k) C_k.(H dy_k)
  float* qbuf = rbuf + qpad;           // w_k B_k.(dH xbar_k)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nc = Tn / Q;
  const int64_t xs = (int64_t)nh * P, bs = (int64_t)G * N;
  const int64_t hs = (int64_t)nh * N;  // row stride of dBh, dCh

  for (int e = threadIdx.x; e < TILE_FLOATS; e += THREADS) sG[e] = 0.0f;

  for (int c = nc - 1; c >= 0; --c) {
    const int64_t t0 = (int64_t)b * Tn + (int64_t)c * Q;
    load_tile(sH, states + (((int64_t)b * nh + h) * nc + c) * N * P, P, N, P);
    for (int k = threadIdx.x; k < qpad; k += THREADS)
      rowpart[k] = colpart[k] = rbuf[k] = qbuf[k] = 0.0f;
    __syncthreads();
    chunk_decays(la + t0 * nh + h, nh, Q, qpad, cum, ecum, wv);
    const float etot = expf(cum[Q - 1]);

    float gacc[4][4];                  // dH before this chunk, rows n, cols p
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        gacc[a][bb] = etot * sG[(ty + 16 * a) * LD + tx + 16 * bb];

    for (int I = 0; I < nsub; ++I) {
      const int i0 = I * TILE, ni = min(TILE, Q - i0);
      __syncthreads();                 // sC, sDY are free
      load_tile(sC, Cm + (t0 + i0) * bs + (int64_t)g * N, bs, ni, N);
      load_tile(sDY, dy + (t0 + i0) * xs + (int64_t)h * P, xs, ni, P);
      __syncthreads();

      // dC_i = exp(cum_i) H dy_i (rows i, cols n) and r_i = C_i . dC_i
      float dcacc[4][4] = {};
      for (int k = 0; k < P; ++k) {
        float dv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = sDY[(ty + 16 * a) * LD + k];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) hv[bb] = sH[(tx + 16 * bb) * LD + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) dcacc[a][bb] = fmaf(dv[a], hv[bb], dcacc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const float e = ecum[i0 + i];
        float r = 0.0f;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          dcacc[a][bb] *= e;
          r = fmaf(sC[i * LD + tx + 16 * bb], dcacc[a][bb], r);
        }
        r = half_warp_sum(r);
        if (tx == 0 && i < ni) rbuf[i0 + i] = r;
      }
      // dH before the chunk += exp(cum_i) C_i^T dy_i
      for (int k = 0; k < ni; ++k) {
        const float e = ecum[i0 + k];
        float cv[4], dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = e * sC[k * LD + ty + 16 * a];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) dv[bb] = sDY[k * LD + tx + 16 * bb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) gacc[a][bb] = fmaf(cv[a], dv[bb], gacc[a][bb]);
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * TILE, nj = min(TILE, Q - j0);
        const bool diag = J == I;
        __syncthreads();               // sB, sX, sS, sD, sM are free
        load_tile(sB, Bm + (t0 + j0) * bs + (int64_t)g * N, bs, nj, N);
        load_tile(sX, xbar + (t0 + j0) * xs + (int64_t)h * P, xs, nj, P);
        __syncthreads();
        float cb[4][4] = {}, ds[4][4] = {};
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * LD + k];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) bv[bb] = sB[(tx + 16 * bb) * LD + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) cb[a][bb] = fmaf(cv[a], bv[bb], cb[a][bb]);
        }
        for (int k = 0; k < P; ++k) {
          float dv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) dv[a] = sDY[(ty + 16 * a) * LD + k];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) xv[bb] = sX[(tx + 16 * bb) * LD + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) ds[a][bb] = fmaf(dv[a], xv[bb], ds[a][bb]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int j = tx + 16 * bb;
            const bool ok = i0 + i >= j0 + j && i < ni && j < nj;
            float sv = 0.0f, dl = 0.0f, mv = 0.0f;
            if (ok) {                  // the exponent only where allowed
              const float L = expf(cum[i0 + i] - cum[j0 + j]);
              sv = cb[a][bb] * L;
              dl = ds[a][bb] * L;
              mv = sv * ds[a][bb];
            }
            sS[i * LD + j] = sv;
            sD[i * LD + j] = dl;
            sM[i * LD + j] = mv;
          }
        }
        __syncthreads();

        // rows and columns of M, each entry by one thread
        if (threadIdx.x < TILE) {
          const int i = threadIdx.x;
          if (i < ni) {
            float t = 0.0f;
            for (int k = 0; k < nj; ++k) t += sM[i * LD + k];
            rowpart[i0 + i] += t;
          }
        } else if (threadIdx.x < 2 * TILE) {
          const int j = threadIdx.x - TILE;
          if (j < nj) {
            float t = 0.0f;
            for (int k = 0; k < ni; ++k) t += sM[k * LD + j];
            colpart[j0 + j] += t;
          }
        }

        // dC_I += (dS*L) B_J
        for (int k = 0; k < nj; ++k) {
          float dv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) dv[a] = sD[(ty + 16 * a) * LD + k];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) bv[bb] = sB[k * LD + tx + 16 * bb];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) dcacc[a][bb] = fmaf(dv[a], bv[bb], dcacc[a][bb]);
        }

        // dxbar_J += S^T dY_I (+ w_j B_j dH on the diagonal, with q_j)
        float acc[4][4] = {};
        for (int k = 0; k < ni; ++k) {
          float sv[4], dv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = sS[k * LD + ty + 16 * a];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) dv[bb] = sDY[k * LD + tx + 16 * bb];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(sv[a], dv[bb], acc[a][bb]);
        }
        if (diag) {
          float hx[4][4] = {};
          for (int k = 0; k < N; ++k) {
            float bv[4], gv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) bv[a] = sB[(ty + 16 * a) * LD + k];
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) gv[bb] = sG[k * LD + tx + 16 * bb];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int bb = 0; bb < 4; ++bb) hx[a][bb] = fmaf(bv[a], gv[bb], hx[a][bb]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int j = ty + 16 * a;
            const float wj = wv[j0 + j];
            float qv = 0.0f;
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              hx[a][bb] *= wj;
              qv = fmaf(hx[a][bb], sX[j * LD + tx + 16 * bb], qv);
              acc[a][bb] += hx[a][bb];
            }
            qv = half_warp_sum(qv);
            if (tx == 0 && j < nj) qbuf[j0 + j] = qv;
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = ty + 16 * a;
          if (j >= nj) continue;
          float* row = dx + (t0 + j0 + j) * xs + (int64_t)h * P;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int p = tx + 16 * bb;
            if (p < P) row[p] = diag ? acc[a][bb] : row[p] + acc[a][bb];
          }
        }

        // dB_J += (dS*L)^T C_I (+ w_j dH xbar_j on the diagonal)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.0f;
        for (int k = 0; k < ni; ++k) {
          float dv[4], cv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) dv[a] = sD[k * LD + ty + 16 * a];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) cv[bb] = sC[k * LD + tx + 16 * bb];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(dv[a], cv[bb], acc[a][bb]);
        }
        if (diag) {
          float hb[4][4] = {};
          for (int k = 0; k < P; ++k) {
            float xv[4], gv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) xv[a] = sX[(ty + 16 * a) * LD + k];
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) gv[bb] = sG[(tx + 16 * bb) * LD + k];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int bb = 0; bb < 4; ++bb) hb[a][bb] = fmaf(xv[a], gv[bb], hb[a][bb]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float wj = wv[j0 + ty + 16 * a];
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(wj, hb[a][bb], acc[a][bb]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = ty + 16 * a;
          if (j >= nj) continue;
          float* row = dBh + (t0 + j0 + j) * hs + (int64_t)h * N;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int n = tx + 16 * bb;
            if (n < N) row[n] = diag ? acc[a][bb] : row[n] + acc[a][bb];
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= ni) continue;
        float* row = dCh + (t0 + i0 + i) * hs + (int64_t)h * N;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int n = tx + 16 * bb;
          if (n < N) row[n] = dcacc[a][bb];
        }
      }
    }
    __syncthreads();                   // rowpart, colpart, r, q are complete

    // dtot = sum_k q_k + exp(tot) <H, dH>
    float part = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int o = (ty + 16 * a) * LD + tx + 16 * bb;
        part = fmaf(sH[o], sG[o], part);
      }
    part *= etot;
    for (int k = threadIdx.x; k < Q; k += THREADS) part += qbuf[k];
    const float dtot = block_sum(part, red);

    // dla_m = sum_{k >= m} dcum_k + dtot: warp 0 scans from the chunk's end
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float carry = dtot;
      for (int base = 0; base < Q; base += 32) {
        const int k = Q - 1 - (base + lane);
        float v = k >= 0 ? rowpart[k] - colpart[k] + rbuf[k] - qbuf[k] : 0.0f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (k >= 0) dla[(t0 + k) * nh + h] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();                   // every read of the old dH is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        sG[(ty + 16 * a) * LD + tx + 16 * bb] = gacc[a][bb];
    __syncthreads();
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

size_t fwd_smem(int Q) {
  const int qpad = (Q + TILE - 1) / TILE * TILE;
  return (size_t)(5 * TILE_FLOATS + 3 * qpad) * sizeof(float);
}

size_t bwd_smem(int Q) {
  const int qpad = (Q + TILE - 1) / TILE * TILE;
  return (size_t)(9 * TILE_FLOATS + 7 * qpad) * sizeof(float);
}

template <typename T>
int fwd(const void* xbar, const void* la, const void* B, const void* C,
        void* y, void* states, int batch, int Tn, int nh, int P, int G,
        int N, int Q, cudaStream_t s) {
  const size_t smem = fwd_smem(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd<T><<<dim3(nh, batch), THREADS, smem, s>>>(
      static_cast<const float*>(xbar), static_cast<const float*>(la),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(y), static_cast<float*>(states), Tn, nh, P, G, N,
      Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* dy, const void* xbar, const void* la, const void* B,
        const void* C, const void* states, void* dx, void* dla, void* dBh,
        void* dCh, void* dB, void* dC, int batch, int Tn, int nh, int P,
        int G, int N, int Q, cudaStream_t s) {
  const size_t smem = bwd_smem(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd<T><<<dim3(nh, batch), THREADS, smem, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(xbar),
      static_cast<const float*>(la), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(states),
      static_cast<float*>(dx), static_cast<float*>(dla),
      static_cast<float*>(dBh), static_cast<float*>(dCh), Tn, nh, P, G, N,
      Q);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const int64_t per = (int64_t)batch * Tn * G * N;
  const int64_t blocks = (2 * per + THREADS - 1) / THREADS;
  group_sum<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const float*>(dBh), static_cast<const float*>(dCh),
      static_cast<T*>(dB), static_cast<T*>(dC), per, G, nh / G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of B and C).  Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int k5_ssd_fwd(const void* xbar, const void* la, const void* B,
                          const void* C, void* y, void* states, int batch,
                          int Tn, int nh, int P, int G, int N, int Q,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(xbar, la, B, C, y, states, batch, Tn, nh, P, G, N, Q, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(xbar, la, B, C, y, states, batch, Tn, nh, P, G,
                              N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dBh, dCh: float32 (b, T, nh, N) scratch for the per-head partials.
extern "C" int k5_ssd_bwd(const void* dy, const void* xbar, const void* la,
                          const void* B, const void* C, const void* states,
                          void* dx, void* dla, void* dBh, void* dCh, void* dB,
                          void* dC, int batch, int Tn, int nh, int P, int G,
                          int N, int Q, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(dy, xbar, la, B, C, states, dx, dla, dBh, dCh, dB, dC,
                      batch, Tn, nh, P, G, N, Q, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(dy, xbar, la, B, C, states, dx, dla, dBh, dCh,
                              dB, dC, batch, Tn, nh, P, G, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
