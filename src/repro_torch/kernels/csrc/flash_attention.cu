// K2: flash attention, forward and backward, with the contract of the JAX
// model's models/blocks.py:flash_attention_jnp.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (wrapper kernels/ops.py:pallas_flash), forward only on the
// TPU; the backward here computes what jax.grad of flash_attention_jnp does.
//
//   q and k (B, S, H, DK), v (B, Sk, Hkv, DV), Hq = Hkv * group, query head
//   h reads kv head h / group (the Pallas kernel's group-major fold);
//   q_pos (B, Sq) and k_pos (Sk,) int32.  Key k is allowed for query row i
//   iff k_pos >= 0 and, when causal, q_pos >= k_pos (and q_pos - k_pos <
//   window when a window is set).  Logits are (q * scale) . k in f32; the
//   probabilities enter the PV product rounded to v's dtype, with f32
//   accumulation.  out (B, Sq, Hq, DV) in q's dtype; lse (B, Hq, Sq) f32 =
//   m + log(l).  DK = DV, or (DK, DV) = (192, 128): MLA's training
//   attention (q and k of 128 + 64 rope dims, v of 128).
//
// Backward (FlashAttention-2 with P recomputed from lse):
//   delta_i = rowsum(dout_i * out_i), P = exp(S - lse) (0 where masked),
//   dV = P^T dO (P in v's dtype), dP = dO V^T, dS = P (dP - delta),
//   dQ = scale dS K, dK = dS^T (scale q).
//
// Bound on an H100: operations (at d = 64 each K/V element read is used by
// 2 * 64 flops per q tile), f32 on CUDA cores in this version.
//
// Design: BT x BT tiles of Q, K, V, dO and P in shared memory as f32, rows
// padded to an odd stride so that the strided reads of a tile are free of
// bank conflicts; 256 threads, each owning a (BT / 16) x (cols / 16)
// register tile of every product, all FMA in f32 (never TF32).  BT is 64,
// and 32 at d = 256, where the backward's four 64-row f32 tiles would need
// (4 * 64 * 257 + 64 * 65) * 4 = 279,808 bytes of shared memory, above an
// H100's 232,448: at BT = 32 the backward takes (4 * 32 * 257 + 32 * 33) * 4
// = 135,808 bytes and the forward 102,912.  d = 48 runs at BT = 64 with
// three 16-column register tiles per row.  With DK != DV the QK and dK
// products run over DK and the PV, dP = dO V^T, dV and delta ones over DV;
// at (192, 128) BT is 32 (tile_rows of the wider), the forward takes
// (2 * 32 * 193 + 32 * 129 + 32 * 33) * 4 = 70,144 bytes and the backward
// (2 * 32 * 193 + 2 * 32 * 129 + 32 * 33) * 4 = 86,656.  The TPU grid
// carries the online softmax from one kv block to the next; here one block per (q tile,
// q head, batch) loops over the k tiles itself.  A (q tile, k tile) pair with
// no allowed entry is skipped before its K and V (backward: Q and dO) are
// read.  The backward runs two kernels and uses no atomics, so dq, dk and dv
// are the same from run to run:
//   dq:   one block per (q tile, q head, batch) loops over the k tiles; it
//         also computes delta for its rows (its own pass, recomputing P and
//         dP, rather than per-block partials of dq);
//   dkdv: one block per (k tile, kv head, batch) loops over the q heads of
//         its GQA group and their q tiles, so dk and dv sum the group in
//         registers.
// No tensor cores (mma / wgmma) and no TMA yet: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

// rows of a q or k tile: 32 at d = 256 (shared memory), else 64
__host__ __device__ constexpr int tile_rows(int D) { return D > 128 ? 32 : 64; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void* q; const void* k; const void* v; const void* out;
  const void* dout; const int* q_pos; const int* k_pos;
  void* o; float* lse; float* delta; void* dq; void* dk; void* dv;
  int B, Sq, Sk, Hq, Hkv, group, causal, window;
  float scale;
};

__device__ __forceinline__ bool allowed(int qp, int kp, bool qok, int causal,
                                        int window) {
  if (!qok || kp < 0) return false;
  if (causal) {
    if (qp < kp) return false;
    if (window && qp - kp >= window) return false;
  }
  return true;
}

// rows [r0, r0 + BT) of head h of a (B, S, H, D) tensor into a (BT, D+1)
// f32 tile, times mul; rows past S are zero.
template <typename T, int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int r0, int S, int H, int h,
                                          float mul) {
  for (int idx = threadIdx.x; idx < BT * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int s = r0 + r;
    float v = 0.0f;
    if (s < S) v = to_f(src[(((int64_t)b * S + s) * H + h) * D + c]) * mul;
    dst[r * (D + 1) + c] = v;
  }
}

// acc[i][j] += sum_t A(t, ty + 16 i) * B(t, tx + 16 j) (i < R, j < NJ), where
// A(t, r) = As[r * ARS + t * ATS] and B(t, c) = Bs[c * BCS + t * BTS].
template <int NT, int R, int NJ, int ARS, int ATS, int BCS, int BTS>
__device__ __forceinline__ void mm(float (&acc)[R][NJ], const float* As,
                                   const float* Bs, int ty, int tx) {
#pragma unroll 4
  for (int t = 0; t < NT; ++t) {
    float a[R], b[NJ];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = As[(ty + 16 * i) * ARS + t * ATS];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = Bs[(tx + 16 * j) * BCS + t * BTS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// max / sum over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// ---------------------------------------------------------------- forward
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(THREADS) fa_fwd(Args a) {
  constexpr int KDP = DK + 1, VDP = DV + 1, NJ = DV / 16;
  constexpr int BQ = tile_rows(DK > DV ? DK : DV), BK = BQ, KP = BK + 1;
  constexpr int R = BQ / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * KDP;
  float* Vs = Ks + BK * KDP;
  float* Ps = Vs + BK * VDP;
  __shared__ int qpos[BQ], kpos[BK];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_tile<T, DK, BQ>(Qs, q, b, q0, a.Sq, a.Hq, h, a.scale);
  if (threadIdx.x < BQ)
    qpos[threadIdx.x] = q0 + (int)threadIdx.x < a.Sq
        ? a.q_pos[(int64_t)b * a.Sq + q0 + threadIdx.x] : 0;
  __syncthreads();
  int qp[R];
  bool qok[R];
  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    qp[i] = qpos[ty + 16 * i];
    qok[i] = q0 + ty + 16 * i < a.Sq;
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < a.Sk; k0 += BK) {
    __syncthreads();  // the previous tile's K, V, P and kpos are consumed
    if (threadIdx.x < BK)
      kpos[threadIdx.x] = k0 + (int)threadIdx.x < a.Sk
          ? a.k_pos[k0 + threadIdx.x] : -1;
    __syncthreads();
    bool ok[R][R], any = false;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[i][j] = allowed(qp[i], kpos[tx + 16 * j], qok[i], a.causal,
                           a.window);
        any |= ok[i][j];
      }
    if (!__syncthreads_or(any)) continue;  // skipped before K/V are read
    load_tile<T, DK, BQ>(Ks, k, b, k0, a.Sk, a.Hkv, kh, 1.0f);
    load_tile<T, DV, BQ>(Vs, v, b, k0, a.Sk, a.Hkv, kh, 1.0f);
    __syncthreads();
    float s[R][R] = {};
    mm<DK, R, R, KDP, 1, KDP, 1>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!ok[i][j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * KP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mm<BK, R, NJ, KP, 1, 1, VDP>(acc, Ps, Vs, ty, tx);
  }

  T* out = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!qok[i]) continue;
    const int row = q0 + ty + 16 * i;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = out + (((int64_t)b * a.Sq + row) * a.Hq + h) * DV;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / lc);
    if (tx == 0)
      a.lse[((int64_t)b * a.Hq + h) * a.Sq + row] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------------- backward dq
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(THREADS) fa_bwd_dq(Args a) {
  constexpr int KDP = DK + 1, VDP = DV + 1, NJ = DK / 16;
  constexpr int BQ = tile_rows(DK > DV ? DK : DV), BK = BQ, KP = BK + 1;
  constexpr int R = BQ / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * KDP;
  float* Ks = dOs + BQ * VDP;
  float* Vs = Ks + BK * KDP;
  float* Ps = Vs + BK * VDP;
  __shared__ int qpos[BQ], kpos[BK];
  __shared__ float lse_s[BQ], delta_s[BQ];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / a.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* out = static_cast<const T*>(a.out);
  const int64_t row0 = ((int64_t)b * a.Hq + h) * a.Sq;

  load_tile<T, DK, BQ>(Qs, q, b, q0, a.Sq, a.Hq, h, a.scale);
  load_tile<T, DV, BQ>(dOs, static_cast<const T*>(a.dout), b, q0, a.Sq, a.Hq,
                       h, 1.0f);
  if (threadIdx.x < BQ) {
    const bool in = q0 + (int)threadIdx.x < a.Sq;
    qpos[threadIdx.x] = in ? a.q_pos[(int64_t)b * a.Sq + q0 + threadIdx.x] : 0;
    lse_s[threadIdx.x] = in ? a.lse[row0 + q0 + threadIdx.x] : 0.0f;
  }
  __syncthreads();
  // delta = rowsum(dout * out) over DV, one warp per row
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float d = 0.0f;
    if (q0 + r < a.Sq) {
      const T* orow = out + (((int64_t)b * a.Sq + q0 + r) * a.Hq + h) * DV;
      for (int c = lane; c < DV; c += 32) d += dOs[r * VDP + c] * to_f(orow[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) {
      delta_s[r] = d;
      if (q0 + r < a.Sq) a.delta[row0 + q0 + r] = d;
    }
  }
  __syncthreads();
  int qp[R];
  bool qok[R];
  float lse[R], dl[R], dq[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    qp[i] = qpos[r];
    qok[i] = q0 + r < a.Sq;
    lse[i] = lse_s[r];
    dl[i] = delta_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < a.Sk; k0 += BK) {
    __syncthreads();
    if (threadIdx.x < BK)
      kpos[threadIdx.x] = k0 + (int)threadIdx.x < a.Sk
          ? a.k_pos[k0 + threadIdx.x] : -1;
    __syncthreads();
    bool ok[R][R], any = false;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[i][j] = allowed(qp[i], kpos[tx + 16 * j], qok[i], a.causal,
                           a.window);
        any |= ok[i][j];
      }
    if (!__syncthreads_or(any)) continue;
    load_tile<T, DK, BQ>(Ks, k, b, k0, a.Sk, a.Hkv, kh, 1.0f);
    load_tile<T, DV, BQ>(Vs, v, b, k0, a.Sk, a.Hkv, kh, 1.0f);
    __syncthreads();
    float s[R][R] = {}, dp[R][R] = {};
    mm<DK, R, R, KDP, 1, KDP, 1>(s, Qs, Ks, ty, tx);
    mm<DV, R, R, VDP, 1, VDP, 1>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[i][j] ? expf(s[i][j] - lse[i]) : 0.0f;
        Ps[(ty + 16 * i) * KP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    mm<BK, R, NJ, KP, 1, 1, KDP>(dq, Ps, Ks, ty, tx);
  }

  T* dqo = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!qok[i]) continue;
    T* row = dqo + (((int64_t)b * a.Sq + q0 + ty + 16 * i) * a.Hq + h) * DK;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(dq[i][j] * a.scale);
  }
}

// ----------------------------------------------------------- backward dk/dv
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(THREADS) fa_bwd_dkdv(Args a) {
  constexpr int KDP = DK + 1, VDP = DV + 1, NK = DK / 16, NV = DV / 16;
  constexpr int BQ = tile_rows(DK > DV ? DK : DV), BK = BQ, KP = BK + 1;
  constexpr int R = BQ / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * KDP;
  float* Qs = Vs + BK * VDP;
  float* dOs = Qs + BQ * KDP;
  float* Ps = dOs + BQ * VDP;
  __shared__ int qpos[BQ], kpos[BK];
  __shared__ float lse_s[BQ], delta_s[BQ];
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);

  load_tile<T, DK, BQ>(Ks, static_cast<const T*>(a.k), b, k0, a.Sk, a.Hkv, kh,
                       1.0f);
  load_tile<T, DV, BQ>(Vs, static_cast<const T*>(a.v), b, k0, a.Sk, a.Hkv, kh,
                       1.0f);
  if (threadIdx.x < BK)
    kpos[threadIdx.x] = k0 + (int)threadIdx.x < a.Sk
        ? a.k_pos[k0 + threadIdx.x] : -1;
  __syncthreads();
  int kp[R];
  float dk[R][NK], dv[R][NV];
#pragma unroll
  for (int j = 0; j < R; ++j) kp[j] = kpos[tx + 16 * j];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < NK; ++j) dk[i][j] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) dv[i][j] = 0.0f;
  }

  for (int g = 0; g < a.group; ++g) {
    const int h = kh * a.group + g;
    const int64_t row0 = ((int64_t)b * a.Hq + h) * a.Sq;
    for (int q0 = 0; q0 < a.Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P, lse and delta are consumed
      if (threadIdx.x < BQ) {
        const bool in = q0 + (int)threadIdx.x < a.Sq;
        qpos[threadIdx.x] =
            in ? a.q_pos[(int64_t)b * a.Sq + q0 + threadIdx.x] : 0;
        lse_s[threadIdx.x] = in ? a.lse[row0 + q0 + threadIdx.x] : 0.0f;
        delta_s[threadIdx.x] = in ? a.delta[row0 + q0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      bool ok[R][R], any = false;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = ty + 16 * i;
          ok[i][j] = allowed(qpos[r], kp[j], q0 + r < a.Sq, a.causal,
                             a.window);
          any |= ok[i][j];
        }
      if (!__syncthreads_or(any)) continue;  // skipped before Q/dO are read
      load_tile<T, DK, BQ>(Qs, q, b, q0, a.Sq, a.Hq, h, a.scale);
      load_tile<T, DV, BQ>(dOs, dout, b, q0, a.Sq, a.Hq, h, 1.0f);
      __syncthreads();
      float s[R][R] = {}, p[R][R];
      mm<DK, R, R, KDP, 1, KDP, 1>(s, Qs, Ks, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          p[i][j] = ok[i][j] ? expf(s[i][j] - lse_s[ty + 16 * i]) : 0.0f;
          Ps[(ty + 16 * i) * KP + tx + 16 * j] = round_to<T>(p[i][j]);
        }
      __syncthreads();
      mm<BQ, R, NV, 1, KP, 1, VDP>(dv, Ps, dOs, ty, tx);    // dV += P^T dO
      float dp[R][R] = {};
      mm<DV, R, R, VDP, 1, VDP, 1>(dp, dOs, Vs, ty, tx);    // dP = dO V^T
      __syncthreads();                                    // P is consumed
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          Ps[(ty + 16 * i) * KP + tx + 16 * j] =
              p[i][j] * (dp[i][j] - delta_s[ty + 16 * i]);
      __syncthreads();
      mm<BQ, R, NK, 1, KP, 1, KDP>(dk, Ps, Qs, ty, tx);     // dK += dS^T (scale q)
    }
  }

  T* dko = static_cast<T*>(a.dk);
  T* dvo = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= a.Sk) continue;
    const int64_t row = ((int64_t)b * a.Sk + r) * a.Hkv + kh;
#pragma unroll
    for (int j = 0; j < NK; ++j) dko[row * DK + tx + 16 * j] = from_f<T>(dk[i][j]);
#pragma unroll
    for (int j = 0; j < NV; ++j) dvo[row * DV + tx + 16 * j] = from_f<T>(dv[i][j]);
  }
}

template <typename K>
int launch(K kernel, dim3 grid, size_t smem, cudaStream_t s, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of a pass holding `kt` (BT, DK + 1) and `vt`
// (BT, DV + 1) f32 tiles and the (BT, BT + 1) P tile
constexpr size_t smem_bytes(int DK, int DV, int kt, int vt) {
  return (size_t)(tile_rows(DK > DV ? DK : DV)
                  * (kt * (DK + 1) + vt * (DV + 1)
                     + tile_rows(DK > DV ? DK : DV) + 1)) * sizeof(float);
}

template <typename T, int DK, int DV>
int fwd(const Args& a, cudaStream_t s) {
  constexpr int BT = tile_rows(DK > DV ? DK : DV);
  return launch(fa_fwd<T, DK, DV>, dim3((a.Sq + BT - 1) / BT, a.Hq, a.B),
                smem_bytes(DK, DV, 2, 1), s, a);
}

template <typename T, int DK, int DV>
int bwd(const Args& a, cudaStream_t s) {
  constexpr int BT = tile_rows(DK > DV ? DK : DV);
  int err = launch(fa_bwd_dq<T, DK, DV>,
                   dim3((a.Sq + BT - 1) / BT, a.Hq, a.B),
                   smem_bytes(DK, DV, 2, 2), s, a);
  if (err != 0) return err;
  return launch(fa_bwd_dkdv<T, DK, DV>,
                dim3((a.Sk + BT - 1) / BT, a.Hkv, a.B),
                smem_bytes(DK, DV, 2, 2), s, a);
}

template <int DK, int DV>
int dispatch(bool backward, int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 0)
    return backward ? bwd<float, DK, DV>(a, s) : fwd<float, DK, DV>(a, s);
  if (dtype == 1)
    return backward ? bwd<__nv_bfloat16, DK, DV>(a, s)
                    : fwd<__nv_bfloat16, DK, DV>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(bool backward, int DK, int DV, int dtype, const Args& a,
        cudaStream_t s) {
  if (DK != DV) {
    if (DK == 192 && DV == 128) return dispatch<192, 128>(backward, dtype, a, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (DK) {
    case 16: return dispatch<16, 16>(backward, dtype, a, s);
    case 32: return dispatch<32, 32>(backward, dtype, a, s);
    case 48: return dispatch<48, 48>(backward, dtype, a, s);
    case 64: return dispatch<64, 64>(backward, dtype, a, s);
    case 128: return dispatch<128, 128>(backward, dtype, a, s);
    case 256: return dispatch<256, 256>(backward, dtype, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, out and the gradients share it);
// (DK, DV) = (d, d) for d in {16, 32, 48, 64, 128, 256}, or (192, 128).
// Returns cudaGetLastError() after the launch.
extern "C" int k2_flash_fwd(const void* q, const void* k, const void* v,
                            const void* q_pos, const void* k_pos, void* out,
                            void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                            int DK, int DV, int causal, int window,
                            float scale, int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v;
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  a.o = out; a.lse = static_cast<float*>(lse);
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.group = Hq / Hkv;
  a.causal = causal; a.window = window; a.scale = scale;
  return run(false, DK, DV, dtype, a, static_cast<cudaStream_t>(stream));
}

// delta: float32 (B, Hq, Sq) scratch, written by the dq kernel and read by
// the dk/dv kernel.
extern "C" int k2_flash_bwd(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const void* lse, const void* q_pos,
                            const void* k_pos, void* delta, void* dq,
                            void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                            int Hkv, int DK, int DV, int causal, int window,
                            float scale, int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.out = out; a.dout = dout;
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.group = Hq / Hkv;
  a.causal = causal; a.window = window; a.scale = scale;
  return run(true, DK, DV, dtype, a, static_cast<cudaStream_t>(stream));
}
