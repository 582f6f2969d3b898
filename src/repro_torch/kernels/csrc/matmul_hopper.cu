// K1 on Hopper's tensor cores: the "tc" route (prefill and training GEMMs)
// and the "decode" route (the few-row GEMMs of a decode step) of
// kernels/matmul.py, both bf16 (M,K)@(K,N) [+ bias (N,)] with a fused
// activation, f32 accumulation, the weight read in its (K, N) row-major
// layout (no copy of any weight is made).
//
// Replaces the Pallas kernel src/repro/kernels/matmul.py:_matmul_kernel
// (wrapper kernels/ops.py:pallas_matmul).  Both kernels are built from the
// same Hopper pieces: TMA tensor loads (cp.async.bulk.tensor.2d, 128-byte
// swizzle, zero fill past every edge) into a ring of shared-memory stages,
// a "full" and an "empty" mbarrier per stage, one producer thread issuing
// the loads, and a consumer warp group running wgmma.mma_async on the
// stages that have landed.  The wrapper routes here only when N and K are
// multiples of 8 and x and w start on 16 bytes, as TMA requires.  Every
// output element is one f32 sum in a fixed order: the same inputs give the
// same bits.
//
// tc route, k1_tc_gemm.  Bound on an H100: at M = 4096-8192 and K, N >=
// 2048 every weight byte feeds hundreds of flops, far above the ~295
// flop/byte where bf16 becomes compute bound, so these GEMMs are bound by
// operations at 989 TFLOP/s.  Design: one CTA per 128 x BN output tile (BN
// = 64, 128 or 256, chosen by the wrapper), tiles visited in groups of
// GROUP_M row blocks so that a wave of CTAs shares its x rows and weight
// columns in L2; K walked in 64-deep tiles (128 bytes of bf16, the width
// of the swizzle) through a 4-stage ring.  Warp group 2 is the producer;
// warp groups 0 and 1 each run wgmma m64nBNk16 on their 64 rows, keep one
// group of wgmmas in flight and free a stage once the wgmmas that read it
// have retired.  setmaxnreg moves registers from the producer (40) to the
// consumers (232), who hold a 64 x BN f32 accumulator.  x is K-major (A as
// wgmma wants it); w is MN-major for B, read through wgmma's transpose
// bit.  The epilogue adds the bias, applies the activation in f32, rounds
// to bf16 and masks the ragged M and N edges.
//
// decode route, k1_decode_split + k1_decode_combine.  Bound on an H100:
// each weight element is read once for 2*M flops (M = 8), far below the
// ~295 flop/byte, so the product is bound by the weight's bytes over 3.35
// TB/s.  Design: A and B swapped, so that N is the 64-row side of the
// wgmma and the few rows of x its 8-64 wide side: out^T (N x M) = w^T x^T,
// w^T read MN-major through the transpose bit, x^T K-major.  Split-K over
// many CTAs (the wrapper's plan: at least 2 per SM): CTA (nb, split, mg)
// owns 64 columns, a K range of `len` rows and NM rows of x, and streams
// its 64-column strip of w through a 4-stage TMA ring in tiles of KT rows
// (16, 32 or 64) while one warp group multiplies.  Each CTA writes its f32
// partial (split, row, column) to a workspace the wrapper allocates; a
// second kernel sums the splits in order, adds the bias, applies the
// activation and rounds to bf16.  No atomics.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 384;  // consumer warp groups 0 and 1, producer 2
constexpr int GROUP_M = 16;   // row blocks visited together (L2 reuse)

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

template <int BN>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 2;          // 16 KB
  static constexpr int B_BYTES = BK * BN * 2;          // 8 KB per 64 columns
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  // + 2 * STAGES barriers, + 1 KB to align the ring on the swizzle's 1 KB
  static constexpr int TOTAL = BAR_OFFSET + 2 * STAGES * 8 + 1024;
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
k1_tc_gemm(const __grid_constant__ CUtensorMap map_x,
           const __grid_constant__ CUtensorMap map_w,
           const __nv_bfloat16* __restrict__ bias,
           __nv_bfloat16* __restrict__ out, int M, int N, int K, int act) {
  using S = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + S::BAR_OFFSET;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // tile pid -> (row block, column block), GROUP_M row blocks at a time
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int pid = blockIdx.x;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (pid / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % per_group) % group_m) * BM;
  const int n0 = ((pid % per_group) / group_m) * BN;
  const int ktiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // lane 0 of each of the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full with TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t round = kt / STAGES;
        mbar_wait(empty(s), (round & 1) ^ 1);
        const uint32_t a = base + s * S::STAGE_BYTES;
        const uint32_t b = a + S::A_BYTES;
        mbar_expect_tx(full(s), S::STAGE_BYTES);
        tma_load_2d(a, &map_x, full(s), kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b + j * (BK * 128), &map_w, full(s), n0 + 64 * j,
                      kt * BK);
      }
    }
  } else {
    // ---- consumers: warp group wg multiplies rows wg*64 .. wg*64+63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    const int lane = tid % 32;
    const int warp = (tid % 128) / 32;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full(s), (kt / STAGES) & 1);
      const uint32_t a = base + s * S::STAGE_BYTES + wg * 64 * 128;
      const uint32_t b = base + s * S::STAGE_BYTES + S::A_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 8-row groups 1024 B apart, K advanced 32 B inside the swizzle
        // row; B: 8-k-row groups 1024 B apart, 64-column blocks 8 KB apart,
        // K advanced 16 rows of 128 B
        const uint64_t da = make_desc(a + kk * 32, 16, 1024);
        const uint64_t db = make_desc(b + kk * 16 * 128, BK * 128, 1024);
        wgmma_ss<BN, 0, 1>(acc, da, db);   // w MN-major: trans-b
      }
      wg_commit();
      // keep this tile's group in flight; the previous one has retired
      wg_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % STAGES));
    }
    wg_wait<0>();

    // epilogue: register r of the m64nBN accumulator holds row
    // 16*warp + lane/4 + 8*((r>>1)&1), column 8*(r>>2) + 2*(lane%4) + (r&1)
    const int row_base = m0 + wg * 64 + warp * 16 + lane / 4;
    const int col_base = n0 + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int row = row_base + 8 * ((r >> 1) & 1);
      const int col = col_base + 8 * (r >> 2);
      if (row < M && col < N) {   // N % 8 == 0: col + 1 < N too
        float v0 = acc[r], v1 = acc[r + 1];
        if (bias != nullptr) {
          v0 += __bfloat162float(bias[col]);
          v1 += __bfloat162float(bias[col + 1]);
        }
        __nv_bfloat162 pair;
        pair.x = __float2bfloat16_rn(activate(v0, act));
        pair.y = __float2bfloat16_rn(activate(v1, act));
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * N + col) =
            pair;
      }
    }
  }
}

// ---- decode route ---------------------------------------------------------
constexpr int DCOLS = 64;      // columns of w per CTA: the wgmma's 64 rows
constexpr int DSTAGES = 4;
constexpr int DTHREADS = 160;  // consumer warp group, producer warp
constexpr int DCOMBINE = 256;

template <int NM>
struct DSmem {
  static constexpr int W_BYTES = BK * DCOLS * 2;   // up to 64 rows of 128 B
  static constexpr int X_BYTES = NM * BK * 2;      // NM rows of 128 B
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;  // multiple of 1 KB
  static constexpr int BAR_OFFSET = DSTAGES * STAGE_BYTES;
  static constexpr int TOTAL = BAR_OFFSET + 2 * DSTAGES * 8 + 1024;
};

// CTA (blockIdx.x, .y, .z) = (64-column block, K split, NM-row group).
// kt: rows of w per stage (16, 32 or 64), len a multiple of kt, so that no
// tile crosses into the next split; x is loaded 64 columns wide from the
// tile's first k and only its first kt columns are used.
template <int NM>
__global__ void __launch_bounds__(DTHREADS)
k1_decode_split(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x,
                float* __restrict__ ws, int M, int N, int K, int len,
                int kt) {
  using S = DSmem<NM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + S::BAR_OFFSET;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (DSTAGES + s); };
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * DCOLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * NM;
  const int k0 = split * len;
  const int ntiles = (min(len, K - k0) + kt - 1) / kt;

  if (tid == 0) {
    for (int s = 0; s < DSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warp: one thread streams w and x tiles ----
    if (tid == 128) {
      const uint32_t bytes = kt * DCOLS * 2 + S::X_BYTES;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % DSTAGES;
        mbar_wait(empty(s), ((t / DSTAGES) & 1) ^ 1);
        const uint32_t w_s = base + s * S::STAGE_BYTES;
        mbar_expect_tx(full(s), bytes);
        tma_load_2d(w_s, &map_w, full(s), n0, k0 + t * kt);
        tma_load_2d(w_s + S::W_BYTES, &map_x, full(s), k0 + t * kt, m0);
      }
    }
  } else {
    // ---- consumer warp group: acc (64 columns x NM rows) += w^T x^T ----
    float acc[NM / 2];
#pragma unroll
    for (int i = 0; i < NM / 2; ++i) acc[i] = 0.0f;
    const int lane = tid % 32, warp = tid / 32;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % DSTAGES;
      mbar_wait(full(s), (t / DSTAGES) & 1);
      const uint32_t w_s = base + s * S::STAGE_BYTES;
      wg_fence();
      for (int kk = 0; kk < kt / 16; ++kk) {
        // A = w^T: 64 columns in one 128 B row per k, 8-k groups 1 KB
        // apart, k advanced 16 rows; B = x^T: 8-row groups 1 KB apart, k
        // advanced 32 B inside the swizzle row
        const uint64_t da = make_desc(w_s + kk * 16 * 128, BK * 128, 1024);
        const uint64_t db = make_desc(w_s + S::W_BYTES + kk * 32, 16, 1024);
        wgmma_ss<NM, 1, 0>(acc, da, db);   // w^T MN-major: trans-a
      }
      wg_commit();
      wg_wait<1>();
      if (t > 0 && lane == 0) mbar_arrive(empty((t - 1) % DSTAGES));
    }
    wg_wait<0>();
    // register r holds column 16*warp + lane/4 + 8*((r>>1)&1) of the strip
    // and row 8*(r>>2) + 2*(lane%4) + (r&1) of x
#pragma unroll
    for (int r = 0; r < NM / 2; ++r) {
      const int n = n0 + warp * 16 + lane / 4 + 8 * ((r >> 1) & 1);
      const int m = m0 + 8 * (r >> 2) + 2 * (lane % 4) + (r & 1);
      if (m < M && n < N) ws[((int64_t)split * M + m) * N + n] = acc[r];
    }
  }
}

__global__ void __launch_bounds__(DCOMBINE)
k1_decode_combine(const float* __restrict__ ws,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int M, int N, int splits,
                  int act) {
  const int64_t i = (int64_t)blockIdx.x * DCOMBINE + threadIdx.x;
  const int64_t total = (int64_t)M * N;
  if (i >= total) return;
  float s = 0.0f;
  for (int p = 0; p < splits; ++p) s += ws[p * total + i];
  if (bias != nullptr) s += __bfloat162float(bias[i % N]);
  out[i] = __float2bfloat16_rn(activate(s, act));
}


// a row-major (rows, cols) bf16 matrix read in boxes of box_rows x 64
// columns (128 bytes) under the 128-byte swizzle; out-of-bounds reads are 0
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* x, const void* w, const void* bias, void* out, int M,
           int N, int K, int act, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!encode(&map_x, x, M, K, BM) || !encode(&map_w, w, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1_tc_gemm<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<BN>::TOTAL);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const unsigned grid = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  k1_tc_gemm<BN><<<grid, THREADS, Smem<BN>::TOTAL, stream>>>(
      map_x, map_w, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

template <int NM>
int launch_decode(const void* x, const void* w, const void* bias, void* out,
                  void* ws, int M, int N, int K, int kt, int len, int splits,
                  int act, cudaStream_t stream) {
  CUtensorMap map_w, map_x;
  if (!encode(&map_w, w, K, N, kt) || !encode(&map_x, x, M, K, NM))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1_decode_split<NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DSmem<NM>::TOTAL);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((N + DCOLS - 1) / DCOLS, splits, (M + NM - 1) / NM);
  k1_decode_split<NM><<<grid, DTHREADS, DSmem<NM>::TOTAL, stream>>>(
      map_w, map_x, static_cast<float*>(ws), M, N, K, len, kt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t total = (int64_t)M * N;
  k1_decode_combine<<<(unsigned)((total + DCOMBINE - 1) / DCOMBINE), DCOMBINE,
                      0, stream>>>(static_cast<const float*>(ws),
                                   static_cast<const __nv_bfloat16*>(bias),
                                   static_cast<__nv_bfloat16*>(out), M, N,
                                   splits, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 x (M,K), w (K,N), bias (N,) or null, out (M,N); bn: 64, 128 or 256;
// N and K multiples of 8, x and w 16-byte aligned (the wrapper checks).
// Returns a CUDA error code (0 = success).
extern "C" int k1_tc(const void* x, const void* w, const void* bias,
                     void* out, int M, int N, int K, int bn, int act,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return launch<64>(x, w, bias, out, M, N, K, act, s);
    case 128: return launch<128>(x, w, bias, out, M, N, K, act, s);
    case 256: return launch<256>(x, w, bias, out, M, N, K, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 x (M,K), w (K,N), bias (N,) or null, out (M,N); ws: f32 workspace of
// splits * M * N.  kt: 16, 32 or 64 rows of w per stage; len: K rows per
// split, a multiple of kt; splits = ceil(K / len); nm: 8, 16, 32 or 64
// rows of x per CTA.  N and K multiples of 8, x and w 16-byte aligned (the
// wrapper checks).  Returns a CUDA error code (0 = success).
extern "C" int k1_decode(const void* x, const void* w, const void* bias,
                         void* out, void* ws, int M, int N, int K, int kt,
                         int len, int splits, int nm, int act, void* stream) {
  if ((kt != 16 && kt != 32 && kt != 64) || len <= 0 || len % kt != 0 ||
      splits != (K + len - 1) / len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nm) {
    case 8: return launch_decode<8>(x, w, bias, out, ws, M, N, K, kt, len,
                                    splits, act, s);
    case 16: return launch_decode<16>(x, w, bias, out, ws, M, N, K, kt, len,
                                      splits, act, s);
    case 32: return launch_decode<32>(x, w, bias, out, ws, M, N, K, kt, len,
                                      splits, act, s);
    case 64: return launch_decode<64>(x, w, bias, out, ws, M, N, K, kt, len,
                                      splits, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
