// K7: the dense-layout tile-skipping matmul, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/bsr_matmul.py:_masked_kernel
// (launched by _masked_call, reached through masked_matmul). It computes
//
//     Y(M, N) = X(M, K) @ W^T,   W (N, K) dense in device memory,
//
// where a (bn, bk) tile of W whose entry in the (N/bn, K/bk) tile mask is 0
// contributes nothing, whatever values W holds there. This is the paper's
// negative control: sparsity without format support -- the weight keeps its
// dense layout and only the compute of masked tiles is skipped.
//
// Design. The TPU grid (M/bm, N/bn, K/bk) runs in order and carries the fp32
// accumulator in VMEM across the K axis. Here one block owns one (64-row M
// tile, 64-column chunk of one N tile) and loops over the K tiles in order,
// skipping every tile whose mask is 0: it loads nothing from that tile and
// multiplies nothing (the TPU pipeline DMAs every weight tile whatever the
// mask; this kernel reads only the tiles it multiplies). No atomics; every
// output element is written once, zeros where a row of tiles is all masked.
// Any M (the ragged last M tile is masked) and tile shapes down to (32, 1).
//
// What bounds it. For the same function the least work is that of the
// stored tiles: read X (M*K), the unmasked tiles of W and the mask, write Y
// (M*N), and do 2*M*(unmasked tiles)*bn*bk operations. As for K1, X stays in
// the 50 MB L2 at the serving shapes and the fp32 FMA rate bounds it; the
// weight's dense layout costs strided tile reads (rows of bk values, K apart)
// and the dense footprint in device memory -- the negative control's cost.
// fp32 FMA on CUDA cores; tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // rows of X per block
constexpr int BN = 64;         // output columns per block (chunk of an N tile)
constexpr int BKC = 16;        // depth of one shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
masked_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              const int* __restrict__ mask, TX* __restrict__ y, int M, int K,
              int N, int bn, int bk, int nk, int n_chunks) {
  __shared__ float xs[BKC][BM + 1];
  __shared__ float ws[BKC][BN + 1];

  const int m0 = blockIdx.x * BM;
  const int ntile = blockIdx.y / n_chunks;         // N tile (block row of W)
  const int c0 = (blockIdx.y % n_chunks) * BN;     // first column inside it
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;          // compute lanes
  const int lk = tid % BKC, lr = tid / BKC;        // load lanes

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  const int* mrow = mask + (int64_t)ntile * nk;
  const TW* wrow = w + (int64_t)ntile * bn * K;
  for (int kt = 0; kt < nk; ++kt) {
    if (mrow[kt] == 0) continue;                   // uniform over the block
    const int64_t kcol = (int64_t)kt * bk;
    for (int k0 = 0; k0 < bk; k0 += BKC) {
      const int kk = k0 + lk;
      const bool kin = kk < bk;
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const int r = lr + 16 * i;
        const int m = m0 + r;
        xs[lk][r] = (kin && m < M) ? to_f32(x[(int64_t)m * K + kcol + kk]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int c = lr + 16 * i;
        const int n = c0 + c;
        ws[lk][c] = (kin && n < bn) ? to_f32(wrow[(int64_t)n * K + kcol + kk]) : 0.f;
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
      store(&y[(int64_t)m * N + ntile * bn + c], acc[i][q]);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, const void* mask, void* y, int M,
            int K, int N, int bn, int bk, int nk, int n_chunks, dim3 grid,
            cudaStream_t stream) {
  masked_kernel<TX, TW><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const int*>(mask), static_cast<TX*>(y), M, K, N, bn, bk, nk,
      n_chunks);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer;
// mask is int32 (N/bn, K/bk), row-major; Y has X's dtype. Returns
// cudaGetLastError() after the launch, so a refused launch is reported.
extern "C" int masked_launch(const void* x, const void* w, const void* mask,
                             void* y, int M, int K, int N, int bn, int bk,
                             int x_bf16, int w_bf16, void* stream) {
  if (M <= 0 || bn <= 0 || bk <= 0 || N % bn || K % bk)
    return (int)cudaErrorInvalidConfiguration;
  const int n_chunks = (bn + BN - 1) / BN;
  const long long gy = (long long)(N / bn) * n_chunks;
  if (gy <= 0 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((M + BM - 1) / BM, (unsigned)gy);
  const int nk = K / bk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, mask, y, M, K, N, bn, bk, nk,
                                         n_chunks, grid, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, mask, y, M, K, N, bn, bk, nk, n_chunks,
                                 grid, s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(x, w, mask, y, M, K, N, bn, bk, nk, n_chunks,
                                 grid, s);
  else
    launch<float, float>(x, w, mask, y, M, K, N, bn, bk, nk, n_chunks, grid, s);
  return (int)cudaGetLastError();
}
