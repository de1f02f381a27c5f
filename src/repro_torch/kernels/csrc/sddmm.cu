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
// The TPU grid (nnzt, M/bm) carries each tile's accumulator in VMEM across
// the sequential M axis. Hopper blocks run in parallel, so a block owns one
// 64 x 64 sub-tile of one stored tile and sums its M rows itself, in order,
// with no atomics: two calls agree bit for bit. Two instances, chosen by the
// wrapper (bsr_matmul.sddmm_instance) before the launch:
//
//   * ring (fp32 dY and X, bn and bk multiples of 4, 16-byte aligned): M is
//     cut into S contiguous chunks (bsr_matmul.sddmm_splits picks S from the
//     number of sub-tile blocks and M, so that the grid fills the 132 SMs
//     several times over; S = 1 where it already does). Block (tile,
//     sub-tile, split) streams 16-row slabs of dY's and X's 64 columns
//     through a 4-stage cp.async ring (16-byte copies along the unit stride,
//     each thread's offsets worked out once) and keeps 8 x 4 outputs a
//     thread, one fmaf chain over its chunk's rows in order. With S = 1 it
//     writes the tile; otherwise it writes an fp32 partial into the
//     workspace, and a combine kernel adds the S partials of each output in
//     split order (exact zeros for the padding tiles). With S = 1 each output
//     is the general instance's chain, bit for bit.
//   * general: the first port's kernel, one 256-thread block a sub-tile over
//     all of M, scalar loads: any tile (e.g. 32 x 1), bf16, any alignment.
//
// What bounds it. A call must read the dY and X columns of the stored tiles
// (each once: M x (N + K) at most), write the tiles, and do
// 2 * M * tiles * bn * bk operations; at the main path's M (3072) that is
// well above the card's fp32 ridge, so the fp32 FMA rate bounds it (fp32
// FMA on the CUDA cores: TF32 would not meet the fp32 tolerance). At density
// 0.2 a BERT-base projection has 7-29 stored tiles, 28-116 sub-tile blocks:
// under one wave of SMs without the split. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_dds_common.cuh"  // cp.async, allow_smem, aligned16

namespace {

constexpr int SUB = 64;        // sub-tile edge (bn and bk directions)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

enum Instance { kGeneral = 0, kRing = 1 };

// ----------------------------------------------------- instance: general

constexpr int BMC = 16;        // rows of M per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int LOADS = BMC * SUB / THREADS;  // slab elements a thread loads

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

// -------------------------------------------------------- instance: ring

constexpr int RING_ROWS = 16;      // rows of M a stage
constexpr int RING_STAGES = 4;
constexpr int RING_THREADS = 128;  // 8 (n) x 16 (k) threads
constexpr int RING_TN = 8;         // sub-tile rows a thread (consecutive n)
constexpr int RING_TK = 4;         // sub-tile columns a thread (consecutive k)
constexpr int RING_CHUNKS = RING_ROWS * SUB / 4;          // 16-byte copies a slab
constexpr int RING_CPT = RING_CHUNKS / RING_THREADS;      // ... a thread
constexpr int RING_STAGE = 2 * RING_ROWS * SUB;           // floats: dY then X
constexpr int RING_SMEM = RING_STAGES * RING_STAGE * 4;   // 32 KB

// Four fp32 outputs at p (16-byte aligned): one vector store.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  union { uint2 u; __nv_bfloat16 h[4]; } b;
#pragma unroll
  for (int i = 0; i < 4; ++i) b.h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint2*>(p) = b.u;
}

// thread (tn, tk) = (tid / 16, tid % 16) owns sub-tile rows 8 tn .. 8 tn + 7
// and columns 4 tk .. 4 tk + 3; split blockIdx.z sums rows
// [z * chunk, min(M, (z + 1) * chunk)) and writes `out` (one split) or its
// fp32 partial in part[z] (n_real, bn, bk)
template <typename TO>
__global__ void __launch_bounds__(RING_THREADS)
sddmm_ring_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                  TO* __restrict__ out, float* __restrict__ part,
                  const int* __restrict__ row_blk,
                  const int* __restrict__ col_blk, int M, int N, int K,
                  int bn, int bk, int n_real, int nsub_k, int chunk) {
  extern __shared__ __align__(16) float ring[];
  const int j = blockIdx.x;
  const int n0 = (blockIdx.y / nsub_k) * SUB;
  const int k0 = (blockIdx.y % nsub_k) * SUB;
  const int split = blockIdx.z, n_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int tn = tid / 16, tk = tid % 16;
  if (j >= n_real && n_splits > 1) return;  // the combine writes its zeros

  float acc[RING_TN][RING_TK];
#pragma unroll
  for (int i = 0; i < RING_TN; ++i)
#pragma unroll
    for (int q = 0; q < RING_TK; ++q) acc[i][q] = 0.f;

  if (j < n_real) {
    const int m_lo = split * chunk, m_hi = min(M, m_lo + chunk);
    const int n_slabs = (m_hi - m_lo + RING_ROWS - 1) / RING_ROWS;
    // this thread's copies of every slab: row r, columns 4 c .. 4 c + 3 of
    // the 64; the source advances by 16 rows a slab
    const float* ysrc[RING_CPT];
    const float* xsrc[RING_CPT];
    int row[RING_CPT], dst[RING_CPT];
    bool yok[RING_CPT], xok[RING_CPT];
    const int64_t ycol = (int64_t)row_blk[j] * bn + n0;
    const int64_t xcol = (int64_t)col_blk[j] * bk + k0;
#pragma unroll
    for (int i = 0; i < RING_CPT; ++i) {
      const int e = tid + RING_THREADS * i;
      const int r = e / (SUB / 4), c = 4 * (e % (SUB / 4));
      row[i] = m_lo + r;
      dst[i] = r * SUB + c;
      yok[i] = n0 + c < bn;
      xok[i] = k0 + c < bk;
      ysrc[i] = dy + (int64_t)row[i] * N + ycol + (yok[i] ? c : 0);
      xsrc[i] = x + (int64_t)row[i] * K + xcol + (xok[i] ? c : 0);
    }
    int issued = 0;
    auto issue = [&]() {
      if (issued < n_slabs) {
        float* st = ring + (issued % RING_STAGES) * RING_STAGE;
        const int dm = issued * RING_ROWS;
#pragma unroll
        for (int i = 0; i < RING_CPT; ++i) {
          const bool in = row[i] + dm < m_hi;
          plan_dds::cp_async16(st + dst[i],
                               in && yok[i] ? ysrc[i] + (int64_t)dm * N : dy,
                               in && yok[i]);
          plan_dds::cp_async16(st + RING_ROWS * SUB + dst[i],
                               in && xok[i] ? xsrc[i] + (int64_t)dm * K : x,
                               in && xok[i]);
        }
        ++issued;
      }
      plan_dds::cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < RING_STAGES - 1; ++s) issue();
    for (int s = 0; s < n_slabs; ++s) {
      plan_dds::cp_async_wait<RING_STAGES - 2>();
      __syncthreads();
      issue();  // into the stage slab s - 1 used: every thread is past it
      const float* ys = ring + (s % RING_STAGES) * RING_STAGE;
      const float* xs = ys + RING_ROWS * SUB;
      // rows past the chunk are zeros in both slabs: fmaf(0, 0, acc) is acc
#pragma unroll
      for (int r = 0; r < RING_ROWS; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(ys + r * SUB + RING_TN * tn);
        const float4 a1 = *reinterpret_cast<const float4*>(ys + r * SUB + RING_TN * tn + 4);
        const float4 b4 = *reinterpret_cast<const float4*>(xs + r * SUB + RING_TK * tk);
        const float a[RING_TN] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[RING_TK] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < RING_TN; ++i)
#pragma unroll
          for (int q = 0; q < RING_TK; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
    }
    plan_dds::cp_async_wait<0>();
  }

  const int k = k0 + RING_TK * tk;
  if (k >= bk) return;  // bk % 4 == 0: a thread's 4 columns are all in or out
  const int64_t tile_elems = (int64_t)bn * bk;
#pragma unroll
  for (int i = 0; i < RING_TN; ++i) {
    const int n = n0 + RING_TN * tn + i;
    if (n >= bn) continue;
    const int64_t at = (int64_t)n * bk + k;
    if (n_splits == 1)
      store4(out + j * tile_elems + at, acc[i]);
    else
      store4(part + ((int64_t)split * n_real + j) * tile_elems + at, acc[i]);
  }
}

constexpr int COMBINE_THREADS = 256;

// out[j] = ((part[0][j] + part[1][j]) + ...) + part[S-1][j] for j < n_real,
// exact zeros for the padding tiles; 4 consecutive outputs a thread
template <typename TO>
__global__ void __launch_bounds__(COMBINE_THREADS)
sddmm_combine_kernel(const float* __restrict__ part, TO* __restrict__ out,
                     int64_t tile_elems, int n_tiles, int n_real,
                     int n_splits) {
  const int64_t e = 4 * ((int64_t)blockIdx.x * COMBINE_THREADS + threadIdx.x);
  if (e >= n_tiles * tile_elems) return;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (e < n_real * tile_elems) {
    const int64_t stride = n_real * tile_elems;
    const float4 p0 = *reinterpret_cast<const float4*>(part + e);
    v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
    for (int s = 1; s < n_splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(part + s * stride + e);
      v[0] += p.x; v[1] += p.y; v[2] += p.z; v[3] += p.w;
    }
  }
  store4(out + e, v);
}

template <typename TO>
int launch_ring(const float* dy, const float* x, TO* out, float* part,
                const int* row_blk, const int* col_blk, int M, int N, int K,
                int bn, int bk, int n_tiles, int n_real, int nsub_k,
                dim3 grid, int chunk, cudaStream_t stream) {
  sddmm_ring_kernel<TO><<<grid, RING_THREADS, RING_SMEM, stream>>>(
      dy, x, out, part, row_blk, col_blk, M, N, K, bn, bk, n_real, nsub_k,
      chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || grid.z == 1) return (int)e;
  const int64_t tile_elems = (int64_t)bn * bk;
  const int64_t quads = n_tiles * tile_elems / 4;
  const int64_t blocks = (quads + COMBINE_THREADS - 1) / COMBINE_THREADS;
  sddmm_combine_kernel<TO><<<(unsigned)blocks, COMBINE_THREADS, 0, stream>>>(
      part, out, tile_elems, n_tiles, n_real, (int)grid.z);
  return (int)cudaGetLastError();
}

template <typename TA, typename TO>
void launch_general(const void* dy, const void* x, void* out,
                    const void* row_blk, const void* col_blk, int M, int N,
                    int K, int bn, int bk, int n_real, int nsub_k, dim3 grid,
                    cudaStream_t stream) {
  sddmm_kernel<TA, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(dy), static_cast<const TA*>(x),
      static_cast<TO*>(out), static_cast<const int*>(row_blk),
      static_cast<const int*>(col_blk), M, N, K, bn, bk, n_real, nsub_k);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer;
// dY and X share one dtype (a_bf16), out is fp32 or bf16 (out_bf16).
// `instance` is 0 (general) or 1 (ring); the ring sums M in `splits` chunks
// of `chunk` rows (the last may be shorter, none empty) and, for splits > 1,
// needs `part`: fp32 (splits, n_real, bn, bk). An instance that cannot take
// the call is refused with cudaErrorInvalidValue before any launch. Returns
// cudaGetLastError() after the launches, so a refused launch is reported.
extern "C" int sddmm_launch(const void* dy, const void* x, void* out,
                            void* part, const void* row_blk,
                            const void* col_blk, int M, int N, int K, int bn,
                            int bk, int n_tiles, int n_real, int a_bf16,
                            int out_bf16, int instance, int splits, int chunk,
                            void* stream) {
  const int nsub_n = (bn + SUB - 1) / SUB;
  const int nsub_k = (bk + SUB - 1) / SUB;
  const long long gy = (long long)nsub_n * nsub_k;
  if (M <= 0 || n_tiles <= 0 || bn <= 0 || bk <= 0 || gy > 65535 ||
      n_real < 0 || n_real > n_tiles)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == kGeneral) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_tiles, (unsigned)gy);
    if (a_bf16 && out_bf16)
      launch_general<__nv_bfloat16, __nv_bfloat16>(
          dy, x, out, row_blk, col_blk, M, N, K, bn, bk, n_real, nsub_k, grid, s);
    else if (a_bf16)
      launch_general<__nv_bfloat16, float>(dy, x, out, row_blk, col_blk, M, N,
                                           K, bn, bk, n_real, nsub_k, grid, s);
    else if (out_bf16)
      launch_general<float, __nv_bfloat16>(dy, x, out, row_blk, col_blk, M, N,
                                           K, bn, bk, n_real, nsub_k, grid, s);
    else
      launch_general<float, float>(dy, x, out, row_blk, col_blk, M, N, K, bn,
                                   bk, n_real, nsub_k, grid, s);
    return (int)cudaGetLastError();
  }
  if (instance != kRing || a_bf16 || bn % 4 || bk % 4 || N % 4 || K % 4 ||
      !plan_dds::aligned16(dy) || !plan_dds::aligned16(x) ||
      !plan_dds::aligned16(out) || splits < 1 || splits > 65535 ||
      chunk < 1 || (long long)(splits - 1) * chunk >= M ||
      (long long)splits * chunk < M ||
      (splits > 1 && (part == nullptr || !plan_dds::aligned16(part))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tiles, (unsigned)gy, (unsigned)splits);
  const float* fdy = static_cast<const float*>(dy);
  const float* fx = static_cast<const float*>(x);
  float* fpart = static_cast<float*>(part);
  const int* rb = static_cast<const int*>(row_blk);
  const int* cb = static_cast<const int*>(col_blk);
  if (out_bf16)
    return launch_ring(fdy, fx, static_cast<__nv_bfloat16*>(out), fpart, rb,
                       cb, M, N, K, bn, bk, n_tiles, n_real, nsub_k, grid,
                       chunk, s);
  return launch_ring(fdy, fx, static_cast<float*>(out), fpart, rb, cb, M, N,
                     K, bn, bk, n_tiles, n_real, nsub_k, grid, chunk, s);
}
