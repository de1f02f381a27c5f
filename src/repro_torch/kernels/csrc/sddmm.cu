// K5: SDDMM, the gradient of the stored tiles, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/bsr_matmul.py:_sddmm_kernel
// (launched by _sddmm_call, reached through sddmm and plan_sddmm). For every
// listed tile j at block (row_blk[j], col_blk[j]) it computes
//
//     out[j](bn, bk) = dY[:, row_j*bn : (row_j+1)*bn]^T @ X[:, col_j*bk : (col_j+1)*bk]
//
// reduced over all M rows, and writes zeros for tiles j >= n_real (the
// padding tiles of a KernelBSR pack, which must stay dead).
//
// Design. The TPU grid (nnzt, M/bm) carries each tile's accumulator in VMEM
// across the sequential M axis. Hopper blocks run in parallel, so here one
// block owns one 64 x 64 sub-tile of one stored tile and loops over all of M
// itself, in order: no atomics and no second pass, so results repeat bit for
// bit. A 128 x 128 tile is four blocks, which lets the 12-34 stored tiles of a
// BERT-base projection at density 0.2 fill the 132 SMs.
//
// What bounds it. A call must read the dY and X columns of the stored tiles
// (each once: M x (N + K) at most) and write the tiles, and do
// 2 * M * tiles * bn * bk operations; at the main path's M (3072) that is
// well above the card's fp32 ridge, so the limit is the fp32 FMA rate (no
// tensor cores). Each stage stages a 16-row slab of dY and of X (64 columns
// each, loads along the unit stride) in shared memory and reuses every
// element 64 times from registers (4 x 4 outputs a thread). wgmma, TMA and
// a split of M with a fixed-order combine for small tile counts are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BMC = 16;        // rows of M per shared-memory stage
constexpr int SUB = 64;        // sub-tile edge (bn and bk directions)
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int LOADS = BMC * SUB / THREADS;  // slab elements a thread loads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TA, typename TO>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const TA* __restrict__ dy, const TA* __restrict__ x,
             TO* __restrict__ out, const int* __restrict__ row_blk,
             const int* __restrict__ col_blk, int M, int N, int K, int bn,
             int bk, int n_real, int nsub_k) {
  __shared__ float ds[BMC][SUB + 1];
  __shared__ float xs[BMC][SUB + 1];

  const int j = blockIdx.x;                        // stored tile
  const int n0 = (blockIdx.y / nsub_k) * SUB;      // sub-tile origin
  const int k0 = (blockIdx.y % nsub_k) * SUB;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;          // compute lanes
  TO* o = out + (int64_t)j * bn * bk;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  if (j < n_real) {
    const int64_t ycol = (int64_t)row_blk[j] * bn + n0;
    const int64_t xcol = (int64_t)col_blk[j] * bk + k0;
    for (int m0 = 0; m0 < M; m0 += BMC) {
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {            // column fastest
        const int e = tid + THREADS * q;
        const int c = e % SUB, r = e / SUB;
        const int m = m0 + r;
        ds[r][c] = (m < M && n0 + c < bn) ? to_f32(dy[(int64_t)m * N + ycol + c]) : 0.f;
        xs[r][c] = (m < M && k0 + c < bk) ? to_f32(x[(int64_t)m * K + xcol + c]) : 0.f;
      }
      __syncthreads();
      const int rmax = min(BMC, M - m0);
      for (int r = 0; r < rmax; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ds[r][ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = xs[r][tx + 16 * q];
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
    const int n = n0 + ty + 16 * i;
    if (n >= bn) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + tx + 16 * q;
      if (k >= bk) continue;
      store(&o[(int64_t)n * bk + k], acc[i][q]);
    }
  }
}

template <typename TA, typename TO>
void launch(const void* dy, const void* x, void* out, const void* row_blk,
            const void* col_blk, int M, int N, int K, int bn, int bk,
            int n_real, int nsub_k, dim3 grid, cudaStream_t stream) {
  sddmm_kernel<TA, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(dy), static_cast<const TA*>(x),
      static_cast<TO*>(out), static_cast<const int*>(row_blk),
      static_cast<const int*>(col_blk), M, N, K, bn, bk, n_real, nsub_k);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer;
// dY and X share one dtype (a_bf16), out is fp32 or bf16 (out_bf16). Returns
// cudaGetLastError() after the launch, so a refused launch is reported.
extern "C" int sddmm_launch(const void* dy, const void* x, void* out,
                            const void* row_blk, const void* col_blk, int M,
                            int N, int K, int bn, int bk, int n_tiles,
                            int n_real, int a_bf16, int out_bf16,
                            void* stream) {
  const int nsub_n = (bn + SUB - 1) / SUB;
  const int nsub_k = (bk + SUB - 1) / SUB;
  const long long gy = (long long)nsub_n * nsub_k;
  if (M <= 0 || n_tiles <= 0 || bn <= 0 || bk <= 0 || gy > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)n_tiles, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(dy, x, out, row_blk, col_blk, M, N,
                                         K, bn, bk, n_real, nsub_k, grid, s);
  else if (a_bf16)
    launch<__nv_bfloat16, float>(dy, x, out, row_blk, col_blk, M, N, K, bn,
                                 bk, n_real, nsub_k, grid, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(dy, x, out, row_blk, col_blk, M, N, K, bn,
                                 bk, n_real, nsub_k, grid, s);
  else
    launch<float, float>(dy, x, out, row_blk, col_blk, M, N, K, bn, bk,
                         n_real, nsub_k, grid, s);
  return (int)cudaGetLastError();
}
