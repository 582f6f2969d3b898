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
// Design: a row belongs to a group of W warps (W = 2-8, one row per group,
// 8 / W rows per 256-thread block), and lane t of the group owns the
// 16-byte vectors t, t + 32W, ... of the row: V vectors a lane, with
// V * 32W * (16 / sizeof(T)) = H, so that the row is read once, with
// 16-byte loads, into registers.  The sum of squares (forward) or the dot
// (backward) is a shuffle tree in each warp, then a fixed-order sum over
// the group's warps in shared memory; y or dx is written from the same
// registers.  Instances exist for the paths' widths, H = 2048 (tinyllama,
// gemma, zamba2), 3072 and 4096 (zamba2's gate_ln over d_inner); any other
// width up to MAX_H takes the same kernel with W = 8 (a block per row),
// scalar accesses and bounds checks.
// The backward is persistent: as many blocks as the SMs hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), whose groups take rows
// g, g + G, g + 2G, ... (G groups in all), each loading its next row while
// it reduces and writes the current one; its instances hold two 16-byte
// accesses a lane (three at 3072), so that three blocks fit an SM.  g' is
// read once per block; each lane's columns never change, so its share of
// dg stays in registers across every row it takes.  At the end the block
// sums its groups' dg in group order in shared memory, and a second kernel
// sums the blocks' partials in block order.  No float atomics: the same
// inputs give the same bits (the grid depends only on the card and the
// instance).
//
// Two phases, for a row that a rank holds only part of (the hidden dim
// split over the 3-D cube's out_ax; the caller all-reduces in between):
// MODE 1 of each kernel stops after the row's partial sum (the forward's
// sum of squares, the backward's dot) and writes it, one float a row;
// MODE 2 reads the all-reduced sum in its place and applies it with the
// norm's global width Hn (rstd = 1 / sqrt(ss / Hn + eps), dx's dot / Hn),
// its dg the local columns' share.  MODE 0 is the one-phase kernel,
// Hn = H.  The modes share the instances' loads, layouts and sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// E consecutive elements, loaded and stored as one access (16 bytes when
// E * sizeof(T) == 16)
template <typename T, int E>
struct __align__(sizeof(T) * E) Pack {
  T v[E];
};

// The layout of one instance: T, E elements an access, V accesses a lane,
// W warps a row, EXACT when V * 32W * E == H (no bounds checks).
template <typename T, int E_, int V_, int W_, bool EXACT_>
struct Cfg {
  using Elt = T;
  static constexpr int E = E_, V = V_, W = W_, TPR = 32 * W_,
                       RPC = 8 / W_;
  static constexpr bool EXACT = EXACT_;
  // blocks an SM should hold (the backward's register budget): 3 when a
  // lane holds at most 32 bytes of a row of each tensor
  static constexpr int MIN_BLOCKS = E_ * V_ * sizeof(T) <= 32 ? 3 : 2;
  using P = Pack<T, E_>;
  // first column of access k of thread t of a row
  static __device__ __forceinline__ int col(int k, int t) {
    return (k * TPR + t) * E;
  }
  static __device__ __forceinline__ bool in(int k, int t, int H) {
    return EXACT || col(k, t) < H;
  }
};

// Sum of v over the W warps of a row group; red holds RPC * W floats.
// Every thread of the block must call it (it may synchronise the block).
template <class C>
__device__ __forceinline__ float row_sum(float v, float* red, int group,
                                         int wir) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (C::W == 1) return v;
  if ((threadIdx.x & 31) == 0) red[group * C::W + wir] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < C::W; ++w) t += red[group * C::W + w];
  return t;
}

template <class C, int MODE>
__global__ void __launch_bounds__(THREADS)
rms_fwd(const typename C::Elt* __restrict__ x,
        const typename C::Elt* __restrict__ g, typename C::Elt* __restrict__ y,
        float* __restrict__ rstd, float* __restrict__ ss_io, int64_t M, int H,
        int Hn, float eps, int zc) {
  using T = typename C::Elt;
  using P = typename C::P;
  __shared__ float red[8];
  const int group = threadIdx.x / C::TPR, t = threadIdx.x % C::TPR;
  const int64_t row = (int64_t)blockIdx.x * C::RPC + group;
  const bool live = row < M;
  const T* xr = x + row * H;
  P xv[C::V];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < C::V; ++k) {
    if (live && C::in(k, t, H)) {
      xv[k] = *reinterpret_cast<const P*>(xr + C::col(k, t));
#pragma unroll
      for (int e = 0; e < C::E; ++e) {
        const float v = to_f(xv[k].v[e]);
        ss = fmaf(v, v, ss);
      }
    }
  }
  if (MODE == 2) {
    if (!live) return;
    ss = ss_io[row];                         // the all-reduced sum
  } else {
    ss = row_sum<C>(ss, red, group, t / 32);
    if (!live) return;
    if (MODE == 1) {
      if (t == 0) ss_io[row] = ss;
      return;
    }
  }
  const float r = rsqrtf(ss / (float)Hn + eps);
  if (t == 0) rstd[row] = r;
  const float shift = zc ? 1.0f : 0.0f;
  T* yr = y + row * H;
#pragma unroll
  for (int k = 0; k < C::V; ++k) {
    if (!C::in(k, t, H)) continue;
    const P gv = *reinterpret_cast<const P*>(g + C::col(k, t));
    P out;
#pragma unroll
    for (int e = 0; e < C::E; ++e)
      out.v[e] = from_f<T>((to_f(xv[k].v[e]) * r) * (to_f(gv.v[e]) + shift));
    *reinterpret_cast<P*>(yr + C::col(k, t)) = out;
  }
}

// dg_part[blockIdx.x, :] = this block's partial of dg; needs H floats of
// dynamic shared memory when a block holds more than one row group.  The
// loads of a group's next row are issued before the current row's sum,
// so that they are in flight while it waits and computes.
template <class C, int MODE>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS)
rms_bwd(const typename C::Elt* __restrict__ dy,
        const typename C::Elt* __restrict__ x,
        const typename C::Elt* __restrict__ g,
        const float* __restrict__ rstd, typename C::Elt* __restrict__ dx,
        float* __restrict__ dg_part, float* __restrict__ dot_io, int64_t M,
        int H, int Hn, int zc) {
  using T = typename C::Elt;
  using P = typename C::P;
  extern __shared__ float buf[];
  __shared__ float red[2][8];
  const int group = threadIdx.x / C::TPR, t = threadIdx.x % C::TPR;
  const int wir = t / 32;
  const float shift = zc ? 1.0f : 0.0f;
  P gv[C::V];
  float dg[C::V][C::E];
#pragma unroll
  for (int k = 0; k < C::V; ++k) {
    if (C::in(k, t, H)) gv[k] = *reinterpret_cast<const P*>(g + C::col(k, t));
#pragma unroll
    for (int e = 0; e < C::E; ++e) dg[k][e] = 0.0f;
  }
  // every group of the block walks the same number of steps, so that the
  // row sums' barriers are met by all its threads
  const int64_t stride = (int64_t)gridDim.x * C::RPC;
  const int64_t steps = (M + stride - 1) / stride;
  int64_t row = (int64_t)blockIdx.x * C::RPC + group;
  P xv[C::V], dyv[C::V];
  auto fetch = [&](int64_t r, P (&xo)[C::V], P (&dyo)[C::V]) {
    if (r >= M) return;
#pragma unroll
    for (int k = 0; k < C::V; ++k)
      if (C::in(k, t, H)) {
        xo[k] = *reinterpret_cast<const P*>(x + r * H + C::col(k, t));
        dyo[k] = *reinterpret_cast<const P*>(dy + r * H + C::col(k, t));
      }
  };
  fetch(row, xv, dyv);
  for (int64_t it = 0; it < steps; ++it, row += stride) {
    P xn[C::V], dyn[C::V];
    if (it + 1 < steps) fetch(row + stride, xn, dyn);
    const bool live = row < M;
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < C::V; ++k) {
      if (live && C::in(k, t, H)) {
#pragma unroll
        for (int e = 0; e < C::E; ++e)
          dot += to_f(dyv[k].v[e]) * (to_f(gv[k].v[e]) + shift)
                 * to_f(xv[k].v[e]);
      }
    }
    if (MODE == 2) {
      if (live) dot = dot_io[row];           // the all-reduced dot
    } else {
      // alternate halves of red: one barrier a step suffices
      dot = row_sum<C>(dot, red[it & 1], group, wir);
      if (MODE == 1 && live && t == 0) dot_io[row] = dot;
    }
    if (MODE != 1 && live) {
      const float r = rstd[row];
      const float kx = dot * r * r * r / (float)Hn;
#pragma unroll
      for (int k = 0; k < C::V; ++k) {
        if (!C::in(k, t, H)) continue;
        P out;
#pragma unroll
        for (int e = 0; e < C::E; ++e) {
          const float xe = to_f(xv[k].v[e]), dye = to_f(dyv[k].v[e]);
          out.v[e] = from_f<T>(r * (to_f(gv[k].v[e]) + shift) * dye
                               - xe * kx);
          dg[k][e] += dye * (xe * r);
        }
        *reinterpret_cast<P*>(dx + row * H + C::col(k, t)) = out;
      }
    }
#pragma unroll
    for (int k = 0; k < C::V; ++k) {
      xv[k] = xn[k];
      dyv[k] = dyn[k];
    }
  }
  if (MODE == 1) return;
  float* part = dg_part + (int64_t)blockIdx.x * H;
  if (C::RPC == 1) {
#pragma unroll
    for (int k = 0; k < C::V; ++k)
      if (C::in(k, t, H))
#pragma unroll
        for (int e = 0; e < C::E; ++e) part[C::col(k, t) + e] = dg[k][e];
    return;
  }
  // the block's groups in order: group 0 writes, the others add
  for (int gg = 0; gg < C::RPC; ++gg) {
    if (group == gg) {
#pragma unroll
      for (int k = 0; k < C::V; ++k)
#pragma unroll
        for (int e = 0; e < C::E; ++e) {
          const int c = C::col(k, t) + e;
          buf[c] = gg == 0 ? dg[k][e] : buf[c] + dg[k][e];
        }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < H; c += THREADS) part[c] = buf[c];
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

// The arguments of one call of either kernel in any mode; the mode's
// unused pointers may be null.
struct Args {
  const void *dy, *x, *g;
  void *y, *rstd, *dx, *dg_part, *dg, *sum;   // sum: ss or dot, (M,) f32
  int64_t M;
  int H, Hn, max_blocks, zc;
  float eps;
};

template <class C, int MODE>
int fwd(const Args& a, cudaStream_t s) {
  using T = typename C::Elt;
  const int64_t blocks = (a.M + C::RPC - 1) / C::RPC;
  rms_fwd<C, MODE><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g),
      static_cast<T*>(a.y), static_cast<float*>(a.rstd),
      static_cast<float*>(a.sum), a.M, a.H, a.Hn, a.eps, a.zc);
  return static_cast<int>(cudaGetLastError());
}

template <class C, int MODE>
int bwd(const Args& a, cudaStream_t s) {
  using T = typename C::Elt;
  const int64_t M = a.M;
  const int H = a.H;
  const size_t smem = (C::RPC > 1 && MODE != 1) ? (size_t)H * sizeof(float)
                                                 : 0;
  cudaError_t e = cudaFuncSetAttribute(
      rms_bwd<C, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a persistent grid: as many blocks as the SMs hold at once
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rms_bwd<C, MODE>, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t nblocks = (M + C::RPC - 1) / C::RPC;
  if (nblocks > (int64_t)sms * per_sm) nblocks = (int64_t)sms * per_sm;
  if (nblocks > a.max_blocks) nblocks = a.max_blocks;
  if (nblocks < 1) nblocks = 1;
  rms_bwd<C, MODE><<<(unsigned)nblocks, THREADS, smem, s>>>(
      static_cast<const T*>(a.dy), static_cast<const T*>(a.x),
      static_cast<const T*>(a.g), static_cast<const float*>(a.rstd),
      static_cast<T*>(a.dx), static_cast<float*>(a.dg_part),
      static_cast<float*>(a.sum), M, H, a.Hn, a.zc);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || MODE == 1) return err;
  rms_dg_reduce<T><<<(H + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(a.dg_part), (int)nblocks, H,
      static_cast<T*>(a.dg));
  return static_cast<int>(cudaGetLastError());
}

// The instance for (T, H): the paths' widths read 16 bytes an access, 3
// or 4 accesses a lane, when every tensor starts on 16 bytes (`aligned`);
// other widths, and unaligned views, a block per row with scalar accesses.
template <typename T, int WIDTH>
using Wide = Cfg<T, 16 / sizeof(T), WIDTH == 3072 ? 3 : 4,
                 (sizeof(T) == 2 ? 2 : 4) * (WIDTH == 2048 ? 1 : 2), true>;
// the backward's: two accesses a lane where 8 warps cover the row with
// them (its registers hold this row and the next), three at 3072
template <typename T, int WIDTH>
struct BwdShape {
  static constexpr int VECS = WIDTH * (int)sizeof(T) / 16;  // a row's
  static constexpr int V = WIDTH == 3072 ? 3 : VECS / 256 > 2 ? VECS / 256 : 2;
  static constexpr int W = VECS / (32 * V);
};
template <typename T, int WIDTH>
using WideBwd = Cfg<T, 16 / sizeof(T), BwdShape<T, WIDTH>::V,
                    BwdShape<T, WIDTH>::W, true>;
template <typename T, int V>
using Narrow = Cfg<T, 1, V, 8, false>;

// K3_DISPATCH(CALL, WIDE) returns CALL(C) for the instance C of (T, H,
// aligned), taking WIDE's at the paths' widths
#define K3_DISPATCH(CALL, WIDE)                           \
  do {                                                    \
    using W2 = WIDE<T, 2048>;                             \
    using W3 = WIDE<T, 3072>;                             \
    using W4 = WIDE<T, 4096>;                             \
    using N4 = Narrow<T, 4>;                              \
    using N16 = Narrow<T, 16>;                            \
    using N48 = Narrow<T, 48>;                            \
    if (aligned && H == 2048) return CALL(W2);            \
    if (aligned && H == 3072) return CALL(W3);            \
    if (aligned && H == 4096) return CALL(W4);            \
    if (H <= 1024) return CALL(N4);                       \
    if (H <= 4096) return CALL(N16);                      \
    return CALL(N48);                                     \
  } while (0)

template <typename T, int MODE>
int fwd_any(const Args& a, int aligned, cudaStream_t s) {
  const int H = a.H;
#define K3_FWD(C) fwd<C, MODE>(a, s)
  K3_DISPATCH(K3_FWD, Wide);
#undef K3_FWD
}

template <typename T, int MODE>
int bwd_any(const Args& a, int aligned, cudaStream_t s) {
  const int H = a.H;
#define K3_BWD(C) bwd<C, MODE>(a, s)
  K3_DISPATCH(K3_BWD, WideBwd);
#undef K3_BWD
}

template <int MODE>
int run(bool backward, const Args& a, int aligned, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward ? bwd_any<float, MODE>(a, aligned, s)
                    : fwd_any<float, MODE>(a, aligned, s);
  if (dtype == 1)
    return backward ? bwd_any<__nv_bfloat16, MODE>(a, aligned, s)
                    : fwd_any<__nv_bfloat16, MODE>(a, aligned, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, g, y, dy, dx share it); rstd and the
// row sums are float32 (M,); H at most 48 * 256 = 12288; aligned: every
// tensor starts on 16 bytes.  Each returns cudaGetLastError() after its
// launches (0 = success).
extern "C" int k3_rmsnorm_fwd(const void* x, const void* g, void* y,
                              void* rstd, long long M, int H, float eps,
                              int zc, int aligned, int dtype, void* stream) {
  Args a{nullptr, x, g, y, rstd, nullptr, nullptr, nullptr, nullptr,
         M, H, H, 0, zc, eps};
  return run<0>(false, a, aligned, dtype, stream);
}

// dg_part: float32 (max_blocks, H) scratch, of which the first
// min(max_blocks, ceil(M / rows a block)) rows are used; dg: (H,) in the
// dtype of g.
extern "C" int k3_rmsnorm_bwd(const void* dy, const void* x, const void* g,
                              const void* rstd, void* dx, void* dg_part,
                              void* dg, long long M, int H, int max_blocks,
                              int zc, int aligned, int dtype, void* stream) {
  Args a{dy, x, g, nullptr, const_cast<void*>(rstd), dx, dg_part, dg,
         nullptr, M, H, H, max_blocks, zc, 0.0f};
  return run<0>(true, a, aligned, dtype, stream);
}

// Phase 1 of the forward: ss[row] = sum of x^2 over the row's H columns.
extern "C" int k3_rmsnorm_moments(const void* x, void* ss, long long M,
                                  int H, int aligned, int dtype,
                                  void* stream) {
  Args a{nullptr, x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         ss, M, H, H, 0, 0, 0.0f};
  return run<1>(false, a, aligned, dtype, stream);
}

// Phase 2 of the forward: y and rstd from the all-reduced ss, with the
// norm's width Hn.
extern "C" int k3_rmsnorm_apply(const void* x, const void* g, const void* ss,
                                void* y, void* rstd, long long M, int H,
                                int Hn, float eps, int zc, int aligned,
                                int dtype, void* stream) {
  Args a{nullptr, x, g, y, rstd, nullptr, nullptr, nullptr,
         const_cast<void*>(ss), M, H, Hn, 0, zc, eps};
  return run<2>(false, a, aligned, dtype, stream);
}

// Phase 1 of the backward: dot[row] = sum of dy * g' * x over the row's H
// columns.
extern "C" int k3_rmsnorm_bwd_dot(const void* dy, const void* x,
                                  const void* g, void* dot, long long M,
                                  int H, int max_blocks, int zc, int aligned,
                                  int dtype, void* stream) {
  Args a{dy, x, g, nullptr, nullptr, nullptr, nullptr, nullptr, dot, M, H,
         H, max_blocks, zc, 0.0f};
  return run<1>(true, a, aligned, dtype, stream);
}

// Phase 2 of the backward: dx and the local columns' dg from the
// all-reduced dot, with the norm's width Hn.
extern "C" int k3_rmsnorm_bwd_apply(const void* dy, const void* x,
                                    const void* g, const void* rstd,
                                    const void* dot, void* dx, void* dg_part,
                                    void* dg, long long M, int H, int Hn,
                                    int max_blocks, int zc, int aligned,
                                    int dtype, void* stream) {
  Args a{dy, x, g, nullptr, const_cast<void*>(rstd), dx, dg_part, dg,
         const_cast<void*>(dot), M, H, Hn, max_blocks, zc, 0.0f};
  return run<2>(true, a, aligned, dtype, stream);
}
