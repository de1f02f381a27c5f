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
// The TPU grid (M/bm, N/bn, K/bk) runs in order and carries the fp32
// accumulator in VMEM across the K axis. Here a block owns one (BM-row M
// tile, 64-column chunk of one N tile) and walks the K tiles in order,
// skipping every tile whose mask is 0: it loads nothing from that tile and
// multiplies nothing (the TPU pipeline DMAs every weight tile whatever the
// mask; this kernel reads only the tiles it multiplies). No atomics; every
// output element is written once, zeros where a row of tiles is all masked.
// Each output is one fmaf chain over the unmasked k in order, in both
// instances, so they agree bit for bit. Two instances, chosen by the wrapper
// (bsr_matmul.masked_instance) before the launch:
//
//   * ring (fp32 X and W, bk a multiple of 16, 16-byte aligned): the block
//     first compacts its N tile's mask row into a list of unmasked K tiles in
//     shared memory (one warp, by ballot), then runs a 4-stage cp.async ring
//     of 16-deep slabs across the list with no gaps -- X's rows and W's rows
//     read along the unit stride in 16-byte copies, each thread's offsets
//     worked out once -- with 8 x 4 outputs a thread (K1's fp32 instance's
//     arithmetic). BM is 64 or 32 rows (bsr_matmul.masked_block_rows picks
//     it from M and N/bn), so that the shapes with few N tiles still give
//     the 132 SMs enough blocks.
//   * general: the first port's kernel, one 256-thread block a (64 rows of
//     X, 64 columns of an N tile), scalar loads: any tile down to (32, 1),
//     bf16, any alignment.
//
// What bounds it. For the same function the least work is that of the
// stored tiles: read X (M*K), the unmasked tiles of W and the mask, write Y
// (M*N), and do 2*M*(unmasked tiles)*bn*bk operations. As for K1, X stays in
// the 50 MB L2 at the serving shapes and the fp32 FMA rate bounds it; the
// weight's dense layout costs strided tile reads (rows of bk values, K apart)
// and the dense footprint in device memory -- the negative control's cost.
// fp32 FMA on CUDA cores (TF32 would not meet the fp32 tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_dds_common.cuh"  // cp.async, allow_smem, aligned16

namespace {

enum Instance { kGeneral = 0, kRing = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ----------------------------------------------------- instance: general

constexpr int BM = 64;         // rows of X per block
constexpr int BN = 64;         // output columns per block (chunk of an N tile)
constexpr int BKC = 16;        // depth of one shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

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

// -------------------------------------------------------- instance: ring

constexpr int RING_BK = 16;                 // depth of a slab
constexpr int RING_STAGES = 4;
constexpr int RING_PITCH = RING_BK + 4;     // floats a staged row (80 bytes)
constexpr int RING_TM = 8;                  // rows a thread
constexpr int RING_TN = 4;                  // columns a thread
constexpr int RING_NT = BN / RING_TN;       // threads along n: 16

template <int RB>  // rows of X a block: 64 or 32
struct RingShape {
  static constexpr int THREADS = RB / RING_TM * RING_NT;   // 128 or 64
  static constexpr int MT = THREADS / RING_NT;             // threads along m
  static constexpr int STAGE = (RB + BN) * RING_PITCH;     // floats
  static constexpr int NX = RB * (RING_BK / 4) / THREADS;  // X copies a thread
  static constexpr int NW = BN * (RING_BK / 4) / THREADS;  // W copies a thread
};

// Dynamic shared memory of the ring: its stages, then the count and the list
// of unmasked K tiles of the block's N tile.
template <int RB>
constexpr int ring_smem(int nk) {
  return RING_STAGES * RingShape<RB>::STAGE * 4 + 4 * (1 + nk);
}

// thread (tm, tn) = (tid / 16, tid % 16) owns rows tm + MT i (i < 8) and
// columns tn + 16 q (q < 4) of the block's RB x 64 outputs
template <int RB>
__global__ void __launch_bounds__(RingShape<RB>::THREADS)
masked_ring_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ mask, float* __restrict__ y, int M,
                   int K, int N, int bn, int bk, int nk, int n_chunks) {
  using S = RingShape<RB>;
  extern __shared__ __align__(16) float ring[];
  int* count = reinterpret_cast<int*>(ring + RING_STAGES * S::STAGE);
  int* list = count + 1;
  const int m0 = blockIdx.x * RB;
  const int ntile = blockIdx.y / n_chunks;
  const int c0 = (blockIdx.y % n_chunks) * BN;
  const int tid = threadIdx.x;
  const int tm = tid / RING_NT, tn = tid % RING_NT;

  // the N tile's unmasked K tiles, in order
  if (tid < 32) {
    const int* mrow = mask + (int64_t)ntile * nk;
    int n_on = 0;
    for (int base = 0; base < nk; base += 32) {
      const int kt = base + tid;
      const bool on = kt < nk && mrow[kt] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, on);
      if (on) list[n_on + __popc(ballot & ((1u << tid) - 1u))] = kt;
      n_on += __popc(ballot);
    }
    if (tid == 0) *count = n_on;
  }

  // this thread's copies of every slab: a row of X or W, 4 values of the 16
  int64_t xo[S::NX], wo[S::NW];
  int xd[S::NX], wd[S::NW];
  bool xok[S::NX], wok[S::NW];
#pragma unroll
  for (int i = 0; i < S::NX; ++i) {
    const int e = tid + S::THREADS * i;
    const int r = e / (RING_BK / 4), c = 4 * (e % (RING_BK / 4));
    xok[i] = m0 + r < M;
    xo[i] = (xok[i] ? (int64_t)(m0 + r) * K : 0) + c;
    xd[i] = r * RING_PITCH + c;
  }
#pragma unroll
  for (int i = 0; i < S::NW; ++i) {
    const int e = tid + S::THREADS * i;
    const int r = e / (RING_BK / 4), c = 4 * (e % (RING_BK / 4));
    wok[i] = c0 + r < bn;
    wo[i] = (wok[i] ? ((int64_t)ntile * bn + c0 + r) * K : 0) + c;
    wd[i] = (RB + r) * RING_PITCH + c;
  }

  float acc[RING_TM][RING_TN];
#pragma unroll
  for (int i = 0; i < RING_TM; ++i)
#pragma unroll
    for (int q = 0; q < RING_TN; ++q) acc[i][q] = 0.f;

  __syncthreads();  // the list
  const int spt = bk / RING_BK;              // slabs a K tile
  const int n_slabs = *count * spt;
  int issued = 0, il = 0, ik = 0;            // next slab: list entry, depth
  auto issue = [&]() {
    if (issued < n_slabs) {
      float* st = ring + (issued % RING_STAGES) * S::STAGE;
      const int64_t k = (int64_t)list[il] * bk + ik;
#pragma unroll
      for (int i = 0; i < S::NX; ++i)
        plan_dds::cp_async16(st + xd[i], x + xo[i] + k, xok[i]);
#pragma unroll
      for (int i = 0; i < S::NW; ++i)
        plan_dds::cp_async16(st + wd[i], w + wo[i] + k, wok[i]);
      ik += RING_BK;
      if (ik == bk) {
        ik = 0;
        ++il;
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
    const float* xs = ring + (s % RING_STAGES) * S::STAGE;
    const float* ws = xs + RB * RING_PITCH;
#pragma unroll
    for (int k4 = 0; k4 < RING_BK; k4 += 4) {
      float xa[RING_TM][4], wb[RING_TN][4];
#pragma unroll
      for (int i = 0; i < RING_TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + (tm + S::MT * i) * RING_PITCH + k4);
        xa[i][0] = v.x; xa[i][1] = v.y; xa[i][2] = v.z; xa[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < RING_TN; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws + (tn + RING_NT * q) * RING_PITCH + k4);
        wb[q][0] = v.x; wb[q][1] = v.y; wb[q][2] = v.z; wb[q][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < RING_TM; ++i)
#pragma unroll
          for (int q = 0; q < RING_TN; ++q)
            acc[i][q] = fmaf(xa[i][kk], wb[q][kk], acc[i][q]);
    }
  }
  plan_dds::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RING_TM; ++i) {
    const int m = m0 + tm + S::MT * i;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < RING_TN; ++q) {
      const int c = c0 + tn + RING_NT * q;
      if (c >= bn) continue;
      y[(int64_t)m * N + (int64_t)ntile * bn + c] = acc[i][q];
    }
  }
}

template <int RB>
int smem_configured[16] = {};

template <int RB>
int launch_ring(const float* x, const float* w, const int* mask, float* y,
                int M, int K, int N, int bn, int bk, int nk, int n_chunks,
                long long gy, cudaStream_t stream) {
  const int smem = ring_smem<RB>(nk);
  cudaError_t e = plan_dds::allow_smem(masked_ring_kernel<RB>, smem,
                                       smem_configured<RB>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + RB - 1) / RB, (unsigned)gy);
  masked_ring_kernel<RB><<<grid, RingShape<RB>::THREADS, smem, stream>>>(
      x, w, mask, y, M, K, N, bn, bk, nk, n_chunks);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
void launch_general(const void* x, const void* w, const void* mask, void* y,
                    int M, int K, int N, int bn, int bk, int nk, int n_chunks,
                    dim3 grid, cudaStream_t stream) {
  masked_kernel<TX, TW><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const int*>(mask), static_cast<TX*>(y), M, K, N, bn, bk, nk,
      n_chunks);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer;
// mask is int32 (N/bn, K/bk), row-major; Y has X's dtype. `instance` is 0
// (general) or 1 (ring); the ring's block takes `block_rows` (64 or 32) rows
// of X. An instance that cannot take the call is refused with
// cudaErrorInvalidValue before any launch. Returns cudaGetLastError() after
// the launch, so a refused launch is reported.
extern "C" int masked_launch(const void* x, const void* w, const void* mask,
                             void* y, int M, int K, int N, int bn, int bk,
                             int x_bf16, int w_bf16, int instance,
                             int block_rows, void* stream) {
  if (M <= 0 || bn <= 0 || bk <= 0 || N % bn || K % bk)
    return (int)cudaErrorInvalidConfiguration;
  const int n_chunks = (bn + BN - 1) / BN;
  const long long gy = (long long)(N / bn) * n_chunks;
  if (gy <= 0 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const int nk = K / bk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == kGeneral) {
    const dim3 grid((M + BM - 1) / BM, (unsigned)gy);
    if (x_bf16 && w_bf16)
      launch_general<__nv_bfloat16, __nv_bfloat16>(x, w, mask, y, M, K, N, bn,
                                                   bk, nk, n_chunks, grid, s);
    else if (x_bf16)
      launch_general<__nv_bfloat16, float>(x, w, mask, y, M, K, N, bn, bk, nk,
                                           n_chunks, grid, s);
    else if (w_bf16)
      launch_general<float, __nv_bfloat16>(x, w, mask, y, M, K, N, bn, bk, nk,
                                           n_chunks, grid, s);
    else
      launch_general<float, float>(x, w, mask, y, M, K, N, bn, bk, nk,
                                   n_chunks, grid, s);
    return (int)cudaGetLastError();
  }
  if (instance != kRing || x_bf16 || w_bf16 || bk % RING_BK ||
      !plan_dds::aligned16(x) || !plan_dds::aligned16(w) ||
      (block_rows != 64 && block_rows != 32))
    return (int)cudaErrorInvalidValue;
  const float* fx = static_cast<const float*>(x);
  const float* fw = static_cast<const float*>(w);
  const int* mk = static_cast<const int*>(mask);
  float* fy = static_cast<float*>(y);
  if (block_rows == 64)
    return launch_ring<64>(fx, fw, mk, fy, M, K, N, bn, bk, nk, n_chunks, gy, s);
  return launch_ring<32>(fx, fw, mk, fy, M, K, N, bn, bk, nk, n_chunks, gy, s);
}
