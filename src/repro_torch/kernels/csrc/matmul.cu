// K1: tiled matmul (M,K)@(K,N) [+ bias (N,)] with a fused activation.
//
// Replaces the Pallas kernel src/repro/kernels/matmul.py:_matmul_kernel
// (wrapper kernels/ops.py:pallas_matmul), the local GEMM of every 3-D island.
//
// Bound on an H100: at decode (M = 8) every weight element is read once for
// 2*M flops, far below the ~295 flop/byte where bf16 becomes compute bound,
// so the kernel is bound by the weight's bytes over 3.35 TB/s.  At prefill
// (M = 4096) it is bound by operations.
//
// Design: one 256-thread block per 64x64 output tile; K is walked in 16-deep
// slices staged in shared memory as f32; each thread keeps a 4x4 register
// tile accumulated with fmaf (never TF32), so f32 inputs give f32-exact
// products.  Tiles come from blockIdx and every ragged M, N and K edge is
// masked, so no shape has to divide a tile.  No tensor cores, no TMA, no
// split-K yet: prefill runs at CUDA-core rate, and a decode GEMM launches
// only ceil(N/64) blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// act: 0 none, 1 tanh-GELU (jax.nn.gelu(approximate=True)), 2 SiLU, 3 ReLU
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case 2: return v / (1.0f + expf(-v));
    case 3: return fmaxf(v, 0.0f);
    default: return v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ bias, T* __restrict__ out,
              int M, int N, int K, int act) {
  // As is stored k-major (As[k][m]) so both operands are read as float4 rows
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, kk = i % BK;
      const int64_t gm = row0 + m;
      const int gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? to_f(x[gm * K + gk]) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN;
      const int gk = k0 + kk;
      const int64_t gn = col0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? to_f(w[(int64_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = col0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f(bias[gn]);
      out[gm * N + gn] = from_f<T>(activate(v, act));
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* bias, void* out, int M,
            int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), M, N, K, act);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w, bias and out share it).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int k1_matmul(const void* x, const void* w, const void* bias,
                         void* out, int M, int N, int K, int dtype, int act,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, bias, out, M, N, K, act, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, bias, out, M, N, K, act, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
