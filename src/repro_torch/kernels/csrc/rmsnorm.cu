// K3: RMSNorm forward and backward over the last dim of x (M, H).
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py:_rmsnorm_kernel
// (wrapper kernels/ops.py:pallas_rmsnorm), forward only on the TPU; the
// backward here is what jax.grad of core/linear3d.py:rmsnorm computes.
//
// Forward:  rstd = 1 / sqrt(mean(x^2) + eps) in f32, y = (x * rstd) * g'
//           with g' = g (or g + 1 when zero-centred), cast to x's dtype.
// Backward: dx = rstd * (g' * dy - xhat * mean(xhat * g' * dy)), xhat = x * rstd
//           dg = sum over rows of dy * xhat.
//
// Bound on an H100: bytes.  A norm does ~4 flops per element it reads, far
// below the ~20 flop/byte where f32 CUDA cores, let alone tensor cores, would
// bound it: the forward reads x once and writes y once, the backward reads
// x and dy once and writes dx once.
//
// Design: one 256-thread block per row in the forward (the row's sum of
// squares is a warp-shuffle tree, then a fixed-order sum over the 8 warps:
// no atomics).  The backward gives each block a contiguous run of rows;
// column c of every row is always handled by the same thread, which keeps
// its running dg[c] in shared memory, so the per-block partial needs no
// atomics.  A second kernel sums the per-block partials in block order.  dg
// is therefore the same from run to run (float atomics would reorder it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the block, the same on every thread; the order is fixed
// (shuffle tree within a warp, then warps 0..7), so it is deterministic.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rms_fwd(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
        float* __restrict__ rstd, int H, float eps, int zc) {
  __shared__ float red[WARPS];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * H;
  T* yr = y + row * H;
  float ss = 0.0f;
  for (int c = threadIdx.x; c < H; c += THREADS) {
    const float v = to_f(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = block_sum(ss, red);
  const float r = rsqrtf(ss / (float)H + eps);
  if (threadIdx.x == 0) rstd[row] = r;
  const float shift = zc ? 1.0f : 0.0f;
  for (int c = threadIdx.x; c < H; c += THREADS) {
    const float gv = to_f(g[c]) + shift;
    yr[c] = from_f<T>((to_f(xr[c]) * r) * gv);
  }
}

// dg_part[blockIdx.x, :] = this block's partial of dg; needs H floats of
// dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rms_bwd(const T* __restrict__ dy, const T* __restrict__ x,
        const T* __restrict__ g, const float* __restrict__ rstd,
        T* __restrict__ dx, float* __restrict__ dg_part, int64_t M, int H,
        int rows_per_block, int zc) {
  extern __shared__ float dgs[];
  __shared__ float red[WARPS];
  const float shift = zc ? 1.0f : 0.0f;
  for (int c = threadIdx.x; c < H; c += THREADS) dgs[c] = 0.0f;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < M ? r0 + rows_per_block : M;
  for (int64_t row = r0; row < r1; ++row) {
    const float r = rstd[row];
    const T* xr = x + row * H;
    const T* dyr = dy + row * H;
    float dot = 0.0f;
    for (int c = threadIdx.x; c < H; c += THREADS)
      dot += to_f(dyr[c]) * (to_f(g[c]) + shift) * to_f(xr[c]);
    dot = block_sum(dot, red);
    const float kx = dot * r * r * r / (float)H;
    T* dxr = dx + row * H;
    for (int c = threadIdx.x; c < H; c += THREADS) {
      const float xv = to_f(xr[c]), dyv = to_f(dyr[c]);
      const float gv = to_f(g[c]) + shift;
      dxr[c] = from_f<T>(r * gv * dyv - xv * kx);
      dgs[c] += dyv * (xv * r);  // column c always belongs to this thread
    }
  }
  for (int c = threadIdx.x; c < H; c += THREADS)
    dg_part[(int64_t)blockIdx.x * H + c] = dgs[c];
}

template <typename T>
__global__ void rms_dg_reduce(const float* __restrict__ dg_part, int nparts,
                              int H, T* __restrict__ dg) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  float s = 0.0f;
  for (int p = 0; p < nparts; ++p) s += dg_part[(int64_t)p * H + c];
  dg[c] = from_f<T>(s);
}

template <typename T>
int fwd(const void* x, const void* g, void* y, void* rstd, int64_t M, int H,
        float eps, int zc, cudaStream_t s) {
  rms_fwd<T><<<(unsigned)M, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y),
      static_cast<float*>(rstd), H, eps, zc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* dy, const void* x, const void* g, const void* rstd,
        void* dx, void* dg_part, void* dg, int64_t M, int H,
        int rows_per_block, int nblocks, int zc, cudaStream_t s) {
  rms_bwd<T><<<nblocks, THREADS, (size_t)H * sizeof(float), s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(g), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(dg_part), M, H,
      rows_per_block, zc);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  rms_dg_reduce<T><<<(H + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(dg_part), nblocks, H, static_cast<T*>(dg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, g, y share it); rstd is float32 (M,).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int k3_rmsnorm_fwd(const void* x, const void* g, void* y,
                              void* rstd, long long M, int H, float eps,
                              int zc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, g, y, rstd, M, H, eps, zc, s);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, g, y, rstd, M, H, eps, zc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dg_part: float32 (nblocks, H) scratch; dg: (H,) in the dtype of g.
extern "C" int k3_rmsnorm_bwd(const void* dy, const void* x, const void* g,
                              const void* rstd, void* dx, void* dg_part,
                              void* dg, long long M, int H,
                              int rows_per_block, int nblocks, int zc,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(dy, x, g, rstd, dx, dg_part, dg, M, H, rows_per_block,
                      nblocks, zc, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(dy, x, g, rstd, dx, dg_part, dg, M, H,
                              rows_per_block, nblocks, zc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
