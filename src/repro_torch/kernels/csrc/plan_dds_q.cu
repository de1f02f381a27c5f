// K6: the plan-consuming block-sparse matmul over quantized (int8 / fp8)
// tile values, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/bsr_matmul.py:_plan_dds_q_kernel
// (launched by _plan_dds_q_call, reached through plan_dds_q). It computes
//
//     Y(M, N) = act(X(M, K) @ dequant(Q)^T + bias)
//
// where Q is the RowPackPlan's row-grouped pack (V, P, bn, bk) stored as int8
// or float8_e4m3fn, with fp32 scales (V, P) ('block' granularity: one per
// tile) or (V, 1) ('row': one per virtual row, for tiles of fewer than 128
// values such as 32x1). The schedule is K1's (exec_plan.plan_kernel_sequence):
// for tile j, col_seq[j] is its block column and tile_seq[j] = vrow * P + slot
// its index in the flattened pack, so its scale is scales[tile_seq[j]]
// ('block') or scales[tile_seq[j] / P] ('row') -- no second schedule.
//
// Design. K1's structure (csrc/plan_dds.cu): one block owns one (64-row M
// tile, 64-column chunk of one output block row) and walks that row's run of
// the schedule in order, with no atomics, and writes the output once with the
// fused bias + activation. What differs is the reference's association of
// the dequant: each tile's product is summed in its own fp32 partial
// accumulator and folded in as acc += scale * partial at the end of the tile
// (bsr_matmul.py:462-464), rather than scaling the weight. int8 values are
// read as signed char, fp8 through <cuda_fp8.h> (__nv_fp8_e4m3, sm_89 and
// later); both widen to fp32 in shared memory.
//
// What bounds it. A call must read X (M*K in x's dtype), the stored tiles
// (one byte a value) and their scales, write Y (M*N), and do
// 2*M*nnzt*bn*bk operations. At the serving shapes of BERT (M=384) the fp32
// FMA rate bounds it, as for K1; at decode (M of a few rows) the weight
// stream does, which is where one byte a value pays. The math is fp32 FMA on
// CUDA cores; int8 mma / fp8 wgmma on the tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // rows of X per block
constexpr int BN = 64;         // output columns per block (chunk of a block row)
constexpr int BKC = 16;        // depth of one shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(signed char v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// act codes: 0 none, 1 relu, 2 gelu (tanh form, as jax.nn.gelu), 3 silu
__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == 1) return fmaxf(y, 0.f);
  if (act == 2) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * (y * y * y))));
  }
  if (act == 3) return y * (1.f / (1.f + expf(-y)));
  return y;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
plan_dds_q_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ scales,
                  const float* __restrict__ bias, TX* __restrict__ y,
                  const int* __restrict__ seg, const int* __restrict__ col_seq,
                  const int* __restrict__ tile_seq, int M, int K, int N,
                  int bn, int bk, int n_chunks, int p_max, int row_gran,
                  int act) {
  __shared__ float xs[BKC][BM + 1];
  __shared__ float ws[BKC][BN + 1];

  const int m0 = blockIdx.x * BM;
  const int brow = blockIdx.y / n_chunks;          // output block row
  const int c0 = (blockIdx.y % n_chunks) * BN;     // first column inside it
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;          // compute lanes
  const int lk = tid % BKC, lr = tid / BKC;        // load lanes

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  const int j0 = seg[brow], j1 = seg[brow + 1];
  for (int j = j0; j < j1; ++j) {
    const int t = tile_seq[j];
    const int64_t xcol = (int64_t)col_seq[j] * bk;
    const TW* wt = w + (int64_t)t * bn * bk;
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][q] = 0.f;
    for (int k0 = 0; k0 < bk; k0 += BKC) {
      const int kk = k0 + lk;
      const bool kin = kk < bk;
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const int r = lr + 16 * i;
        const int m = m0 + r;
        xs[lk][r] = (kin && m < M) ? to_f32(x[(int64_t)m * K + xcol + kk]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int c = lr + 16 * i;
        const int n = c0 + c;
        ws[lk][c] = (kin && n < bn) ? to_f32(wt[(int64_t)n * bk + kk]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(BKC, bk - k0);
      for (int k = 0; k < kmax; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = ws[k][tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][q] = fmaf(a[i], b[q], part[i][q]);
      }
      __syncthreads();
    }
    // the tile's dequant: one scalar multiply on its partial product
    const float s = scales[row_gran ? t / p_max : t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(s, part[i][q], acc[i][q]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c >= bn) continue;
      const int n = brow * bn + c;
      float v = acc[i][q];
      if (bias != nullptr) v += bias[n];
      store(&y[(int64_t)m * N + n], apply_act(v, act));
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, const void* scales, const void* bias,
            void* y, const void* seg, const void* col_seq, const void* tile_seq,
            int M, int K, int N, int bn, int bk, int n_chunks, int p_max,
            int row_gran, int act, dim3 grid, cudaStream_t stream) {
  plan_dds_q_kernel<TX, TW><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(scales), static_cast<const float*>(bias),
      static_cast<TX*>(y), static_cast<const int*>(seg),
      static_cast<const int*>(col_seq), static_cast<const int*>(tile_seq), M,
      K, N, bn, bk, n_chunks, p_max, row_gran, act);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer
// (bias may be null); Y has X's dtype. w_fp8 = 0 reads int8 values, 1 reads
// float8_e4m3fn. Returns cudaGetLastError() after the launch, so a refused
// launch is reported to the caller.
extern "C" int plan_dds_q_launch(const void* x, const void* w,
                                 const void* scales, const void* bias, void* y,
                                 const void* seg, const void* col_seq,
                                 const void* tile_seq, int M, int K, int N,
                                 int n_brows, int bn, int bk, int p_max,
                                 int row_gran, int x_bf16, int w_fp8, int act,
                                 void* stream) {
  const int n_chunks = (bn + BN - 1) / BN;
  const long long gy = (long long)n_brows * n_chunks;
  if (M <= 0 || p_max <= 0 || gy <= 0 || gy > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((M + BM - 1) / BM, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_fp8)
    launch<__nv_bfloat16, __nv_fp8_e4m3>(x, w, scales, bias, y, seg, col_seq,
                                         tile_seq, M, K, N, bn, bk, n_chunks,
                                         p_max, row_gran, act, grid, s);
  else if (x_bf16)
    launch<__nv_bfloat16, signed char>(x, w, scales, bias, y, seg, col_seq,
                                       tile_seq, M, K, N, bn, bk, n_chunks,
                                       p_max, row_gran, act, grid, s);
  else if (w_fp8)
    launch<float, __nv_fp8_e4m3>(x, w, scales, bias, y, seg, col_seq, tile_seq,
                                 M, K, N, bn, bk, n_chunks, p_max, row_gran,
                                 act, grid, s);
  else
    launch<float, signed char>(x, w, scales, bias, y, seg, col_seq, tile_seq,
                               M, K, N, bn, bk, n_chunks, p_max, row_gran, act,
                               grid, s);
  return (int)cudaGetLastError();
}
