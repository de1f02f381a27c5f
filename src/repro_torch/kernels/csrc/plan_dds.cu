// K1: the plan-consuming block-sparse matmul, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/bsr_matmul.py:_plan_dds_kernel
// (launched by _plan_dds_call, reached through plan_dds). It computes
//
//     Y(M, N) = act(X(M, K) @ W^T + bias)
//
// where W is the RowPackPlan's row-grouped pack data_rp (V, P, bn, bk) and the
// host-built schedule lists the stored tiles sorted by output block row
// (exec_plan.plan_kernel_sequence): for tile j, col_seq[j] is its block column
// and tile_seq[j] = vrow_seq[j] * P + slot_seq[j] its index in the flattened
// (V * P, bn, bk) pack. seg[r] .. seg[r + 1] is block row r's run of tiles.
//
// Design. The TPU grid (M/bm, nnzt) runs in order and carries the fp32
// accumulator in VMEM from one schedule step to the next. Hopper blocks run
// in parallel and in no order, so here one block owns one (64-row M tile,
// 64-column chunk of one output block row) and loops over that row's segment
// itself, in schedule order: home and spill tiles land in one register
// accumulator, with the JAX kernel's summation order over tiles, no atomics,
// and one write of the output with the fused bias + activation. pack_bsr
// keeps at least one stored tile in every block row, so every output element
// is written.
//
// What bounds it. Per call the kernel must read X (M*K), the stored tiles
// (nnzt*bn*bk) and write Y (M*N), and do 2*M*nnzt*bn*bk operations. It
// re-reads the X columns of every stored tile once per block row and the
// tile values once per M tile; X is small enough to stay in the 50 MB L2, so
// device-memory traffic stays near the one-pass bytes and the limit is the
// fp32 FMA rate (no tensor cores, so fp32 results stay close to the
// reference). Each stage stages a 64 x 16 slab of X and of W in shared
// memory once and reuses every element 64 times from registers (4 x 4
// outputs a thread). Tensor cores (wgmma), TMA and tuned tile shapes are
// left to later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // rows of X per block
constexpr int BN = 64;         // output columns per block (chunk of a block row)
constexpr int BKC = 16;        // depth of one shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
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
plan_dds_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                const float* __restrict__ bias, TX* __restrict__ y,
                const int* __restrict__ seg, const int* __restrict__ col_seq,
                const int* __restrict__ tile_seq, int M, int K, int N, int bn,
                int bk, int n_chunks, int act) {
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
    const int64_t xcol = (int64_t)col_seq[j] * bk;
    const TW* wt = w + (int64_t)tile_seq[j] * bn * bk;
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
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
      __syncthreads();
    }
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
void launch(const void* x, const void* w, const void* bias, void* y,
            const void* seg, const void* col_seq, const void* tile_seq, int M,
            int K, int N, int bn, int bk, int n_chunks, int act, dim3 grid,
            cudaStream_t stream) {
  plan_dds_kernel<TX, TW><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(bias), static_cast<TX*>(y),
      static_cast<const int*>(seg), static_cast<const int*>(col_seq),
      static_cast<const int*>(tile_seq), M, K, N, bn, bk, n_chunks, act);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer
// (bias may be null); Y has X's dtype. Returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.
extern "C" int plan_dds_launch(const void* x, const void* w, const void* bias,
                               void* y, const void* seg, const void* col_seq,
                               const void* tile_seq, int M, int K, int N,
                               int n_brows, int bn, int bk, int x_bf16,
                               int w_bf16, int act, void* stream) {
  const int n_chunks = (bn + BN - 1) / BN;
  const long long gy = (long long)n_brows * n_chunks;
  if (M <= 0 || gy <= 0 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((M + BM - 1) / BM, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, y, seg, col_seq, tile_seq,
                                         M, K, N, bn, bk, n_chunks, act, grid, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, bias, y, seg, col_seq, tile_seq, M, K,
                                 N, bn, bk, n_chunks, act, grid, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(x, w, bias, y, seg, col_seq, tile_seq, M, K,
                                 N, bn, bk, n_chunks, act, grid, s);
  else
    launch<float, float>(x, w, bias, y, seg, col_seq, tile_seq, M, K, N, bn,
                         bk, n_chunks, act, grid, s);
  return (int)cudaGetLastError();
}
