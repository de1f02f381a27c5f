// K4: block-sparse DDS over a row-sorted tile sequence, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/bsr_matmul.py:_dds_kernel (launched
// by _dds_call, reached through dds, dds_t and plan_dds_t). It computes
//
//     Y(M, n_out * ow)[:, r*ow : (r+1)*ow] = sum_j  X[:, in_j*iw : (in_j+1)*iw] @ T_j^T
//
// over output block r's run seg[r] .. seg[r + 1] of a tile sequence sorted
// by output block; tile j is tiles[tile_seq[j]] and T_j is read (ow, iw):
//   * dds    (Y = X @ W^T):  output blocks are W's block rows, T_j the stored
//     (bn, bk) tile as it is (element (o, i) at o * iw + i);
//   * dds_t / plan_dds_t (dX = dY @ W): output blocks are W's block columns,
//     the sequence is the column-sorted transposed pattern and T_j is the
//     transpose of the stored tile, read in place through strides (element
//     (o, i) at i * ow + o) -- no per-call gather and transpose of the tiles
//     as the TPU path does.
//
// Design. The TPU grid (M/bm, nnzt) runs in order and carries the fp32
// accumulator in VMEM from one tile to the next, writing on row change. Here
// one block owns one (64-row M tile, 64-column chunk of one output block) and
// loops over that block's run itself, in sequence order: one register
// accumulator, no atomics, and one write of every output element -- zeros
// where a block has no tiles, so nothing relies on the pack storing a tile in
// every row and column.
//
// What bounds it. A call must read X (M x K_in), the visited tiles and write
// Y (M x N_out), and do 2 * M * tiles * ow * iw operations; as in K1 the X
// slabs are re-read once per output block and stay in the 50 MB L2 at the
// shapes of the main path, so the limit is the fp32 FMA rate (no tensor
// cores). Each stage stages a 64 x 16 slab of X and of the tile in shared
// memory, the fastest load lane on the unit stride of either orientation,
// and reuses every element 64 times from registers (4 x 4 outputs a thread).
// wgmma, TMA and tuned tile shapes are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // rows of X per block
constexpr int BN = 64;         // output columns per block (chunk of a block)
constexpr int BKC = 16;        // depth of one shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int LOADS = BKC * BM / THREADS;  // slab elements a thread loads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
dds_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
           TX* __restrict__ y, const int* __restrict__ seg,
           const int* __restrict__ in_blk, const int* __restrict__ tile_seq,
           int M, int K_in, int N_out, int ow, int iw, int so, int si,
           int o_fast, int n_chunks) {
  __shared__ float xs[BKC][BM + 1];
  __shared__ float ws[BKC][BN + 1];

  const int m0 = blockIdx.x * BM;
  const int orow = blockIdx.y / n_chunks;          // output block
  const int c0 = (blockIdx.y % n_chunks) * BN;     // first column inside it
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;          // compute lanes
  const int64_t tile_elems = (int64_t)ow * iw;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  const int j0 = seg[orow], j1 = seg[orow + 1];
  for (int j = j0; j < j1; ++j) {
    const int64_t xcol = (int64_t)in_blk[j] * iw;
    const TW* wt = w + (int64_t)tile_seq[j] * tile_elems;
    for (int k0 = 0; k0 < iw; k0 += BKC) {
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {            // X slab, depth fastest
        const int e = tid + THREADS * q;
        const int kk = e % BKC, r = e / BKC;
        const int m = m0 + r, k = k0 + kk;
        xs[kk][r] = (k < iw && m < M) ? to_f32(x[(int64_t)m * K_in + xcol + k]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {            // tile slab, unit stride fastest
        const int e = tid + THREADS * q;
        const int c = o_fast ? e % BN : e / BKC;
        const int kk = o_fast ? e / BN : e % BKC;
        const int o = c0 + c, i = k0 + kk;
        ws[kk][c] = (o < ow && i < iw)
                        ? to_f32(wt[(int64_t)o * so + (int64_t)i * si]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(BKC, iw - k0);
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
      if (c >= ow) continue;
      store(&y[(int64_t)m * N_out + (int64_t)orow * ow + c], acc[i][q]);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* y, const void* seg,
            const void* in_blk, const void* tile_seq, int M, int K_in,
            int N_out, int ow, int iw, int so, int si, int o_fast,
            int n_chunks, dim3 grid, cudaStream_t stream) {
  dds_kernel<TX, TW><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), static_cast<const int*>(seg),
      static_cast<const int*>(in_blk), static_cast<const int*>(tile_seq), M,
      K_in, N_out, ow, iw, so, si, o_fast, n_chunks);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer;
// Y has X's dtype. ``transposed`` reads each stored tile (iw, ow) as its
// transpose. Returns cudaGetLastError() after the launch, so a refused launch
// is reported to the caller.
extern "C" int dds_launch(const void* x, const void* w, void* y,
                          const void* seg, const void* in_blk,
                          const void* tile_seq, int M, int K_in, int N_out,
                          int n_out, int ow, int iw, int transposed,
                          int x_bf16, int w_bf16, void* stream) {
  const int n_chunks = (ow + BN - 1) / BN;
  const long long gy = (long long)n_out * n_chunks;
  if (M <= 0 || gy <= 0 || gy > 65535 || ow <= 0 || iw <= 0)
    return (int)cudaErrorInvalidConfiguration;
  // element (o, i) of T_j: stored (ow, iw) tile at o * iw + i, or the
  // transpose of a stored (iw, ow) tile at i * ow + o
  const int so = transposed ? 1 : iw;
  const int si = transposed ? ow : 1;
  // load along o when it has the unit stride and the longer run
  const int o_fast = (so == 1 && (si != 1 || ow >= iw)) ? 1 : 0;
  const dim3 grid((M + BM - 1) / BM, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, seg, in_blk, tile_seq, M,
                                         K_in, N_out, ow, iw, so, si, o_fast,
                                         n_chunks, grid, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, y, seg, in_blk, tile_seq, M, K_in,
                                 N_out, ow, iw, so, si, o_fast, n_chunks, grid,
                                 s);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(x, w, y, seg, in_blk, tile_seq, M, K_in,
                                 N_out, ow, iw, so, si, o_fast, n_chunks, grid,
                                 s);
  else
    launch<float, float>(x, w, y, seg, in_blk, tile_seq, M, K_in, N_out, ow,
                         iw, so, si, o_fast, n_chunks, grid, s);
  return (int)cudaGetLastError();
}
