// K4, simt route: paged flash-decode.  Attention for one new token per
// slot, read straight out of the paged KV pool through the block table.
//
// Replaces the Pallas kernel src/repro/kernels/paged_decode.py:_decode_kernel
// (via _pallas_impl, entry paged_flash_decode) for what the split route
// (paged_decode_hopper.cu) does not take: f32, dv != dk, other head dims,
// groups and block sizes, unaligned tensors (kernels/paged_decode.py:route).
//
// Contract (kernels/paged_decode.py of the reference): q (B,nq,dk),
// k_pool (phys,nkv,dk), v_pool (phys,nkv,dv), pos_pool (phys,) int32,
// tables (B,nb) int32, cur (B,) int32.  Entry e of slot b attends iff
// 0 <= pos <= cur (and cur - pos < window when windowed).  The running max
// starts at -1e30, and p is masked again after the exponent so that a block
// with no valid entry adds nothing.  Query rows group as q.reshape(B,nkv,g,dk).
// q and the pools may differ in type: q f32 over bf16 pools is MLA's latent
// decode (q = (absorbed q_nope, q_rope), 576 wide; k = (c_kv, k_rope), v =
// c_kv, 512 wide; one kv head, g = the heads), which the reference computes
// with every operand cast to f32.  All arithmetic is f32 here too.  Output
// (B,nq,dv) in q's type, or f32 (acc, m, l) with residuals.
//
// Bound on an H100: bytes.  Each step reads every valid K/V entry once and
// does 4*g flops per element read (QK and PV), far below the compute line.
//
// Design: the TPU grid walks table columns in order and carries (m, l, acc)
// in VMEM between grid steps; Hopper blocks run in parallel with nothing
// carried between them.  So one block per (slot, kv head, tile of at most
// ROWS query rows) walks that slot's table columns in a loop, reads
// tables[b, j] itself, stages the (block, dk) K tile and (block, dv) V tile
// in shared memory as f32, and keeps (m, l, acc) of its rows in shared
// memory across the loop.  The row tile bounds the shared memory, g * (dk +
// dv) floats of q and acc, which at MLA's g = 128 would be 557 KB: at ROWS
// = 8, dk 576, dv 512 and block 16 a block takes 105 KB (opted in above 48
// KB), and MLA's 128 heads spread over 16 blocks a slot; each block writes
// the (acc, m, l) of its own rows.  Pool offsets are 64-bit.  A column whose
// positions are all masked (the null block, unwritten tails) is skipped
// before its K/V are read: in the online softmax it would change nothing.
// An id outside the pool is treated as masked.  B*nkv*ceil(g/ROWS) blocks
// (32 at B = 8 on tinyllama) on 132 SMs, one column at a time: the split
// route spreads the columns over the card instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int ROWS = 8;  // query rows of one kv head a block takes at most

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                    const TP* __restrict__ v_pool,
                    const int* __restrict__ pos_pool,
                    const int* __restrict__ tables, const int* __restrict__ cur,
                    void* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int nq, int nkv, int dk, int dv,
                    int block, int nb, int n_blocks, int window, float scale,
                    int residuals, int rows) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * rows;                 // first row of the tile
  const int g = min(rows, nq / nkv - r0);           // rows of this block
  const int tid = threadIdx.x, nt = blockDim.x;

  extern __shared__ float smem[];
  float* qs = smem;                  // rows * dk   (pre-scaled queries)
  float* ks = qs + rows * dk;        // block * (dk + 1), rows padded vs bank conflicts
  float* vs = ks + block * (dk + 1); // block * dv
  float* ps = vs + block * dv;       // rows * block (scores, then probabilities)
  float* acc = ps + rows * block;    // rows * dv
  float* ms = acc + rows * dv;       // rows
  float* ls = ms + rows;             // rows
  float* alpha = ls + rows;          // rows
  int* valid = reinterpret_cast<int*>(alpha + rows);  // block

  const int cur_b = cur[b];
  const int64_t q_row0 = (int64_t)b * nq + (int64_t)h * (nq / nkv) + r0;
  for (int i = tid; i < g * dk; i += nt) {
    qs[i] = to_f(q[q_row0 * dk + i]) * scale;
  }
  for (int i = tid; i < g * dv; i += nt) acc[i] = 0.0f;
  for (int r = tid; r < g; r += nt) {
    ms[r] = NEG_INF;
    ls[r] = 0.0f;
  }

  for (int j = 0; j < nb; ++j) {
    const int blk = tables[(int64_t)b * nb + j];
    const bool in_pool = blk >= 0 && blk < n_blocks;
    const int64_t base = (int64_t)blk * block;  // first pool row of the block
    int any = 0;
    for (int e = tid; e < block; e += nt) {
      const int p = in_pool ? pos_pool[base + e] : -1;
      const int ok = p >= 0 && p <= cur_b && (window == 0 || cur_b - p < window);
      valid[e] = ok;
      any |= ok;
    }
    // every read of valid[] by the previous column precedes its last barrier
    if (!__syncthreads_or(any)) continue;

    for (int i = tid; i < block * dk; i += nt) {
      const int e = i / dk, d = i % dk;
      ks[e * (dk + 1) + d] = to_f(k_pool[((base + e) * nkv + h) * dk + d]);
    }
    for (int i = tid; i < block * dv; i += nt) {
      const int e = i / dv, d = i % dv;
      vs[i] = to_f(v_pool[((base + e) * nkv + h) * dv + d]);
    }
    __syncthreads();

    for (int i = tid; i < g * block; i += nt) {
      const int r = i / block, e = i % block;
      const float* qr = qs + r * dk;
      const float* ke = ks + e * (dk + 1);
      float s = 0.0f;
      for (int d = 0; d < dk; ++d) s = fmaf(qr[d], ke[d], s);
      ps[i] = valid[e] ? s : NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < g; r += nt) {
      float* pr = ps + r * block;
      float mx = NEG_INF;
      for (int e = 0; e < block; ++e) mx = fmaxf(mx, pr[e]);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float a = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int e = 0; e < block; ++e) {
        const float p = valid[e] ? expf(pr[e] - m_new) : 0.0f;
        pr[e] = p;
        sum += p;
      }
      ls[r] = ls[r] * a + sum;
      ms[r] = m_new;
      alpha[r] = a;
    }
    __syncthreads();

    for (int i = tid; i < g * dv; i += nt) {
      const int r = i / dv, d = i % dv;
      const float* pr = ps + r * block;
      float o = acc[i] * alpha[r];
      for (int e = 0; e < block; ++e) o = fmaf(pr[e], vs[e * dv + d], o);
      acc[i] = o;
    }
    __syncthreads();
  }
  __syncthreads();

  for (int i = tid; i < g * dv; i += nt) {
    const int r = i / dv;
    const int64_t o = q_row0 * dv + i;
    if (residuals) {
      static_cast<float*>(out)[o] = acc[i];
    } else {
      static_cast<TQ*>(out)[o] = from_f<TQ>(acc[i] / fmaxf(ls[r], 1e-30f));
    }
  }
  if (m_out != nullptr) {
    for (int r = tid; r < g; r += nt) {
      m_out[q_row0 + r] = ms[r];
      l_out[q_row0 + r] = ls[r];
    }
  }
}

size_t smem_bytes(int rows, int dk, int dv, int block) {
  return sizeof(float) * ((size_t)rows * dk + (size_t)block * (dk + 1) +
                          (size_t)block * dv + (size_t)rows * block +
                          (size_t)rows * dv + 3 * (size_t)rows) +
         sizeof(int) * (size_t)block;
}

template <typename TQ, typename TP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* pos_pool, const void* tables, const void* cur,
           void* out, void* m_out, void* l_out, int B, int nq, int nkv, int dk,
           int dv, int block, int nb, int n_blocks, int window, float scale,
           int residuals, cudaStream_t stream) {
  const int g = nq / nkv;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rows = g < ROWS ? g : ROWS;
  while (rows > 1 && smem_bytes(rows, dk, dv, block) > (size_t)optin)
    rows = (rows + 1) / 2;
  const size_t smem = smem_bytes(rows, dk, dv, block);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_decode_kernel<TQ, TP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, nkv, (g + rows - 1) / rows);
  paged_decode_kernel<TQ, TP><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(pos_pool),
      static_cast<const int*>(tables), static_cast<const int*>(cur), out,
      static_cast<float*>(m_out), static_cast<float*>(l_out), nq, nkv, dk, dv,
      block, nb, n_blocks, window, scale, residuals, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype, pool_dtype: 0 float32, 1 bfloat16 (k_pool and v_pool share the
// pool's; q bfloat16 over float32 pools is not instantiated).  out is f32
// when residuals != 0, else q's dtype; m_out / l_out (f32, (B,nq)) may be
// null.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int k4_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* pos_pool,
                               const void* tables, const void* cur, void* out,
                               void* m_out, void* l_out, int B, int nq, int nkv,
                               int dk, int dv, int block, int nb, int n_blocks,
                               int window, float scale, int q_dtype,
                               int pool_dtype, int residuals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && pool_dtype == 0) {
    return launch<float, float>(q, k_pool, v_pool, pos_pool, tables, cur, out,
                                m_out, l_out, B, nq, nkv, dk, dv, block, nb,
                                n_blocks, window, scale, residuals, s);
  }
  if (q_dtype == 1 && pool_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, pos_pool, tables, cur, out, m_out, l_out, B, nq,
        nkv, dk, dv, block, nb, n_blocks, window, scale, residuals, s);
  }
  if (q_dtype == 0 && pool_dtype == 1) {
    return launch<float, __nv_bfloat16>(
        q, k_pool, v_pool, pos_pool, tables, cur, out, m_out, l_out, B, nq,
        nkv, dk, dv, block, nb, n_blocks, window, scale, residuals, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
