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
// one block owns one (M tile, 64-column chunk of one output block) and
// loops over that block's run itself, in sequence order: one register
// accumulator, no atomics, and one write of every output element -- zeros
// where a block has no tiles, so nothing relies on the pack storing a tile in
// every row and column. Each output is one fmaf chain over the run's tiles
// in order, k ascending inside each tile, in both instances, so they agree
// bit for bit. Two instances, chosen by the wrapper (bsr_matmul.dds_instance)
// before the launch:
//
//   * ring (fp32 X and tiles, iw a multiple of 16, ow of 4, 16-byte aligned
//     X, tiles and Y): a 4-stage cp.async ring of 16-deep slabs runs across
//     the flattened (tile, slab) sequence of the block's whole run, with no
//     gap at a tile boundary; each thread works out its copy offsets once
//     and reads the next tile's indices one tile ahead. X is staged [m][k]
//     and read with float4 along k. The tile slab is staged along its unit
//     stride: [o][k] for dds (read with float4 along k, K7's ring), [k][o]
//     for the transposed orientation (16 contiguous rows of ow values, read
//     with float4 along o: a thread's 4 columns are adjacent). 8 x 4 outputs
//     a thread; BM is 64 or 32 rows (bsr_matmul.dds_block_rows picks it from
//     M and the grid), so that small grids still give the 132 SMs enough
//     blocks.
//   * general: the first port's kernel, one 256-thread block a (64 rows of
//     X, 64 columns of an output block), scalar loads, 4 x 4 outputs a
//     thread: any tile down to (32, 1), bf16, any alignment.
//
// What bounds it. A call must read X (M x K_in), the visited tiles and write
// Y (M x N_out), and do 2 * M * tiles * ow * iw operations; as in K1 the X
// slabs are re-read once per output block and stay in the 50 MB L2 at the
// shapes of the main path, so the limit is the fp32 FMA rate (TF32 tensor
// cores would not meet the fp32 tolerance). wgmma, TMA and a split of long
// runs across blocks (which would change the sums) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_dds_common.cuh"  // cp.async, aligned16

namespace {

enum Instance { kGeneral = 0, kRing = 1 };

// ----------------------------------------------------- instance: general

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

// -------------------------------------------------------- instance: ring

constexpr int RING_BK = 16;                 // depth of a slab
constexpr int RING_STAGES = 4;
constexpr int RING_PITCH = RING_BK + 4;     // floats a staged [.][k] row
constexpr int RING_OPITCH = BN + 4;         // floats a staged [k][o] row
constexpr int RING_TM = 8;                  // rows a thread
constexpr int RING_TN = 4;                  // columns a thread
constexpr int RING_NT = BN / RING_TN;       // threads along n: 16

template <int RB, bool TRANS>  // rows of X a block: 64 or 32
struct RingShape {
  static constexpr int THREADS = RB / RING_TM * RING_NT;   // 128 or 64
  static constexpr int MT = THREADS / RING_NT;             // threads along m
  static constexpr int XS = RB * RING_PITCH;               // floats of X
  static constexpr int WS = TRANS ? RING_BK * RING_OPITCH : BN * RING_PITCH;
  static constexpr int STAGE = XS + WS;                    // floats
  static constexpr int NX = RB * (RING_BK / 4) / THREADS;  // X copies a thread
  static constexpr int NW = BN * (RING_BK / 4) / THREADS;  // tile copies
};

// thread (tm, tn) = (tid / 16, tid % 16) owns rows tm + MT i (i < 8) of the
// block's RB x 64 outputs, and columns tn + 16 q (dds) or 4 tn + q
// (transposed) for q < 4
template <int RB, bool TRANS>
__global__ void __launch_bounds__(RingShape<RB, TRANS>::THREADS)
dds_ring_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, const int* __restrict__ seg,
                const int* __restrict__ in_blk,
                const int* __restrict__ tile_seq, int M, int K_in, int N_out,
                int ow, int iw, int n_chunks) {
  using S = RingShape<RB, TRANS>;
  __shared__ __align__(16) float ring[RING_STAGES * S::STAGE];
  const int m0 = blockIdx.x * RB;
  const int orow = blockIdx.y / n_chunks;          // output block
  const int c0 = (blockIdx.y % n_chunks) * BN;     // first column inside it
  const int tid = threadIdx.x;
  const int tm = tid / RING_NT, tn = tid % RING_NT;
  const int64_t tile_elems = (int64_t)ow * iw;

  // this thread's copies of every slab: 4 of the 16 values of a row of X;
  // 4 of a tile row's 16 (dds) or 4 of a slab row's 64 columns (transposed)
  int64_t xo[S::NX], wo[S::NW];
  int xd[S::NX], wd[S::NW];
  bool xok[S::NX], wok[S::NW];
#pragma unroll
  for (int i = 0; i < S::NX; ++i) {
    const int e = tid + S::THREADS * i;
    const int r = e / (RING_BK / 4), c = 4 * (e % (RING_BK / 4));
    xok[i] = m0 + r < M;
    xo[i] = (xok[i] ? (int64_t)(m0 + r) * K_in : 0) + c;
    xd[i] = r * RING_PITCH + c;
  }
#pragma unroll
  for (int i = 0; i < S::NW; ++i) {
    const int e = tid + S::THREADS * i;
    if (TRANS) {                       // slab row k = e / 16, columns c..c+3
      const int k = e / (BN / 4), c = 4 * (e % (BN / 4));
      wok[i] = c0 + c < ow;
      wo[i] = wok[i] ? (int64_t)k * ow + c0 + c : 0;
      wd[i] = S::XS + k * RING_OPITCH + c;
    } else {                           // tile row o = e / 4, depth c..c+3
      const int r = e / (RING_BK / 4), c = 4 * (e % (RING_BK / 4));
      wok[i] = c0 + r < ow;
      wo[i] = (wok[i] ? (int64_t)(c0 + r) * iw : 0) + c;
      wd[i] = S::XS + r * RING_PITCH + c;
    }
  }

  float acc[RING_TM][RING_TN];
#pragma unroll
  for (int i = 0; i < RING_TM; ++i)
#pragma unroll
    for (int q = 0; q < RING_TN; ++q) acc[i][q] = 0.f;

  // the run's slabs in order: tile j0 slab 0, 1, ..., tile j0 + 1 slab 0, ...
  const int j0 = seg[orow], j1 = seg[orow + 1];
  const int n_slabs = (j1 - j0) * (iw / RING_BK);
  int issued = 0, jn = j0, kn = 0;             // next slab: tile, depth
  int in_cur = 0, tile_cur = 0, in_nxt = 0, tile_nxt = 0;
  if (j0 < j1) {
    in_cur = in_blk[j0];
    tile_cur = tile_seq[j0];
  }
  if (j0 + 1 < j1) {                           // one tile ahead
    in_nxt = in_blk[j0 + 1];
    tile_nxt = tile_seq[j0 + 1];
  }
  auto issue = [&]() {
    if (issued < n_slabs) {
      float* st = ring + (issued % RING_STAGES) * S::STAGE;
      const float* xs = x + (int64_t)in_cur * iw + kn;
      const float* ws = w + (int64_t)tile_cur * tile_elems +
                        (TRANS ? (int64_t)kn * ow : kn);
#pragma unroll
      for (int i = 0; i < S::NX; ++i)
        plan_dds::cp_async16(st + xd[i], xs + xo[i], xok[i]);
#pragma unroll
      for (int i = 0; i < S::NW; ++i)
        plan_dds::cp_async16(st + wd[i], ws + wo[i], wok[i]);
      kn += RING_BK;
      if (kn == iw) {
        kn = 0;
        ++jn;
        in_cur = in_nxt;
        tile_cur = tile_nxt;
        if (jn + 1 < j1) {
          in_nxt = in_blk[jn + 1];
          tile_nxt = tile_seq[jn + 1];
        }
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
    const float* ws = xs + S::XS;
#pragma unroll
    for (int k4 = 0; k4 < RING_BK; k4 += 4) {
      float xa[RING_TM][4], wb[RING_TN][4];
#pragma unroll
      for (int i = 0; i < RING_TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + (tm + S::MT * i) * RING_PITCH + k4);
        xa[i][0] = v.x; xa[i][1] = v.y; xa[i][2] = v.z; xa[i][3] = v.w;
      }
      if (TRANS) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (k4 + kk) * RING_OPITCH + RING_TN * tn);
          wb[0][kk] = v.x; wb[1][kk] = v.y; wb[2][kk] = v.z; wb[3][kk] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < RING_TN; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (tn + RING_NT * q) * RING_PITCH + k4);
          wb[q][0] = v.x; wb[q][1] = v.y; wb[q][2] = v.z; wb[q][3] = v.w;
        }
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
    float* yr = y + (int64_t)m * N_out + (int64_t)orow * ow + c0;
    if (TRANS) {
      if (c0 + RING_TN * tn < ow)
        *reinterpret_cast<float4*>(yr + RING_TN * tn) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int q = 0; q < RING_TN; ++q) {
        const int c = tn + RING_NT * q;
        if (c0 + c < ow) yr[c] = acc[i][q];
      }
    }
  }
}

template <int RB, bool TRANS>
int launch_ring(const void* x, const void* w, void* y, const void* seg,
                const void* in_blk, const void* tile_seq, int M, int K_in,
                int N_out, int ow, int iw, int n_chunks, long long gy,
                cudaStream_t stream) {
  const dim3 grid((M + RB - 1) / RB, (unsigned)gy);
  dds_ring_kernel<RB, TRANS><<<grid, RingShape<RB, TRANS>::THREADS, 0,
                               stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), static_cast<const int*>(seg),
      static_cast<const int*>(in_blk), static_cast<const int*>(tile_seq), M,
      K_in, N_out, ow, iw, n_chunks);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
void launch_general(const void* x, const void* w, void* y, const void* seg,
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
// transpose. ``instance`` is 0 (general) or 1 (ring); the ring's block takes
// ``block_rows`` (64 or 32) rows of X. An instance that cannot take the call
// is refused with cudaErrorInvalidValue before any launch. Returns
// cudaGetLastError() after the launch, so a refused launch is reported.
extern "C" int dds_launch(const void* x, const void* w, void* y,
                          const void* seg, const void* in_blk,
                          const void* tile_seq, int M, int K_in, int N_out,
                          int n_out, int ow, int iw, int transposed,
                          int x_bf16, int w_bf16, int instance,
                          int block_rows, void* stream) {
  const int n_chunks = (ow + BN - 1) / BN;
  const long long gy = (long long)n_out * n_chunks;
  if (M <= 0 || gy <= 0 || gy > 65535 || ow <= 0 || iw <= 0)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == kGeneral) {
    // element (o, i) of T_j: stored (ow, iw) tile at o * iw + i, or the
    // transpose of a stored (iw, ow) tile at i * ow + o
    const int so = transposed ? 1 : iw;
    const int si = transposed ? ow : 1;
    // load along o when it has the unit stride and the longer run
    const int o_fast = (so == 1 && (si != 1 || ow >= iw)) ? 1 : 0;
    const dim3 grid((M + BM - 1) / BM, (unsigned)gy);
    if (x_bf16 && w_bf16)
      launch_general<__nv_bfloat16, __nv_bfloat16>(
          x, w, y, seg, in_blk, tile_seq, M, K_in, N_out, ow, iw, so, si,
          o_fast, n_chunks, grid, s);
    else if (x_bf16)
      launch_general<__nv_bfloat16, float>(x, w, y, seg, in_blk, tile_seq, M,
                                           K_in, N_out, ow, iw, so, si,
                                           o_fast, n_chunks, grid, s);
    else if (w_bf16)
      launch_general<float, __nv_bfloat16>(x, w, y, seg, in_blk, tile_seq, M,
                                           K_in, N_out, ow, iw, so, si,
                                           o_fast, n_chunks, grid, s);
    else
      launch_general<float, float>(x, w, y, seg, in_blk, tile_seq, M, K_in,
                                   N_out, ow, iw, so, si, o_fast, n_chunks,
                                   grid, s);
    return (int)cudaGetLastError();
  }
  if (instance != kRing || x_bf16 || w_bf16 || iw % RING_BK || ow % 4 ||
      K_in % 4 || N_out % 4 || !plan_dds::aligned16(x) ||
      !plan_dds::aligned16(w) || !plan_dds::aligned16(y) ||
      (block_rows != 64 && block_rows != 32))
    return (int)cudaErrorInvalidValue;
  if (block_rows == 64)
    return transposed
               ? launch_ring<64, true>(x, w, y, seg, in_blk, tile_seq, M,
                                       K_in, N_out, ow, iw, n_chunks, gy, s)
               : launch_ring<64, false>(x, w, y, seg, in_blk, tile_seq, M,
                                        K_in, N_out, ow, iw, n_chunks, gy, s);
  return transposed
             ? launch_ring<32, true>(x, w, y, seg, in_blk, tile_seq, M, K_in,
                                     N_out, ow, iw, n_chunks, gy, s)
             : launch_ring<32, false>(x, w, y, seg, in_blk, tile_seq, M, K_in,
                                      N_out, ow, iw, n_chunks, gy, s);
}
