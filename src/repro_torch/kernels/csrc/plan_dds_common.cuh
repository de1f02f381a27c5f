// The shared body of kernels K1 (plan_dds.cu) and K6 (plan_dds_q.cu): the
// plan-consuming block-sparse matmul
//
//     Y(M, N) = act(X(M, K) @ W^T + bias)
//
// where W is the RowPackPlan's row-grouped pack (V, P, bn, bk) and the
// host-built schedule lists the stored tiles sorted by output block row
// (exec_plan.plan_kernel_sequence): for tile j, col_seq[j] is its block column
// and tile_seq[j] = vrow * P + slot its index in the flattened (V * P, bn, bk)
// pack; seg[r] .. seg[r + 1] is block row r's run of tiles, home tiles first,
// then the spill tiles, as the plan lays them out.
//
// Replaces the Pallas TPU kernels kernels/bsr_matmul.py:_plan_dds_kernel and
// _plan_dds_q_kernel. The TPU grid walks the schedule in order and carries
// the fp32 accumulator in VMEM from step to step. Here a block (or a warp)
// owns a piece of one output block row and walks that row's run itself, in
// schedule order, with no atomics, and writes each output once through the
// fused bias + activation epilogue. So two calls are bitwise equal, and a
// block row whose tiles are all zero gives exactly act(bias).
//
// The value policy says what a tile holds:
//   * PlainValues<TX, TW>: fp32 or bf16 values, acc += x * w;
//   * QuantValues<TX, TW>: int8 or fp8 e4m3 values with an fp32 scale a tile
//     ('block': scales[t]) or a virtual row ('row': scales[t / P]). As in the
//     reference (bsr_matmul.py:462-466) each tile's product is summed in its
//     own fp32 partial and folded in as acc += s * partial. Where an instance
//     splits a tile's dot product across lanes it folds per lane,
//     acc_lane += s * partial_lane: a reassociation of the same sum.
//
// Four instances, chosen by the wrapper (bsr_matmul.plan_instance) from
// (M, tile, x dtype, value dtype, alignment) before the launch; none is a
// retry of another:
//   * stream (M <= 16, bk <= 128: decode): the weight stream bounds it (each
//     stored value is read once and used M times). 32 / rw lanes share two
//     rows of a block row, each lane reading 4 values of both rows' tile
//     rows (a 128-deep tile: one lane group a warp); the values of a few
//     tiles and their X columns are loaded into registers before the first
//     FMA, the values evict-first (read once), X through L1. A lane keeps
//     M x 2 fp32 sums for its slice of bk; a fixed xor-shuffle tree adds
//     the lanes, then the epilogue.
//   * fp32 (M > 16, fp32 math): 64 x 64 outputs a block of 4 warps, 8 x 4
//     a thread, fp32 FMA on the CUDA cores (TF32 would not meet the fp32
//     tolerance). 16-deep slabs of X and W move by cp.async, 16 bytes a
//     thread, through a 4-stage ring in shared memory; the ring runs over the
//     whole (tile, slab) sequence of the row, across tile boundaries. Per
//     output it sums in the order of the general instance, so the two agree
//     bit for bit.
//   * tc (M > 16, bf16 x, bf16 / int8 / fp8 values): the same blocks and ring
//     with 32-deep slabs (6 stages, 60 KB for bf16 values), each warp 32 x 32
//     outputs by mma.sync.m16n8k16 on the bf16 tensor cores with fp32
//     accumulation. int8 and fp8 values are exact in bf16 and are widened as
//     each B fragment is built; only the summation order differs from fp32.
//   * general: the first port's kernel, one 256-thread block a (64 rows of X,
//     64 columns of a block row), scalar loads: any tile shape, any alignment,
//     e.g. the paper's 32 x 1.
//
// What bounds the call. It must read X, the stored tiles (and scales) and
// write Y: at decode the tiles' bytes set the least time (27 MB of bf16
// values in a gemma3_4b layer's four packed projections, 8 us at 3.35 TB/s);
// at M of a few hundred the operations do (fp32 FMA at 67 TFLOP/s, bf16
// tensor cores at 989 TFLOP/s). At density 0.2 a block row holds few tiles,
// so the fp32 and tc blocks are small (64 x 64) to give the card enough of
// them. wgmma, TMA and warp specialisation are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace plan_dds {

// ---------------------------------------------------------------- values

// Raw element types, so vector loads can be reinterpreted freely.
struct bf16_t { unsigned short bits; };
struct fp8_t { unsigned char bits; };  // float8_e4m3fn

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_t v) {
  return __uint_as_float(static_cast<unsigned>(v.bits) << 16);
}
__device__ __forceinline__ float to_f32(signed char v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(fp8_t v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.bits, __NV_E4M3)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16_t* p, float v) {
  p->bits = __bfloat16_as_ushort(__float2bfloat16(v));
}

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

// The fused epilogue: one write of each output.
template <typename TX>
__device__ __forceinline__ void write_out(TX* y, int64_t idx, float v,
                                          const float* bias, int n, int act) {
  if (bias != nullptr) v += bias[n];
  store(y + idx, apply_act(v, act));
}

template <typename TX_, typename TW_>
struct PlainValues {
  using TX = TX_;
  using TW = TW_;
  static constexpr bool kQuant = false;
  __device__ static float scale(const float*, int, int, int) { return 1.f; }
};

template <typename TX_, typename TW_>
struct QuantValues {
  using TX = TX_;
  using TW = TW_;
  static constexpr bool kQuant = true;
  // 'block': one scale a tile; 'row': one a virtual row of P slots
  __device__ static float scale(const float* scales, int t, int p_max,
                                int row_gran) {
    return scales[row_gran ? t / p_max : t];
  }
};

// Four consecutive values from shared memory, as fp32.
template <typename T>
__device__ __forceinline__ void smem_f32x4(const T* p, float (&out)[4]) {
  constexpr int BYTES = 4 * static_cast<int>(sizeof(T));
  if constexpr (BYTES == 16) {
    union { uint4 v; T t[4]; } u;
    u.v = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = to_f32(u.t[i]);
  } else if constexpr (BYTES == 8) {
    union { uint2 v; T t[4]; } u;
    u.v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = to_f32(u.t[i]);
  } else {
    union { unsigned v; T t[4]; } u;
    u.v = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = to_f32(u.t[i]);
  }
}

// Two consecutive values from shared memory as a packed bf16 pair (the
// lower index in the low half), exact for bf16, int8 and fp8 e4m3 values.
__device__ __forceinline__ unsigned bf16_pair(const bf16_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
template <typename T>
__device__ __forceinline__ unsigned bf16_pair(const T* p) {
  union { unsigned short v; T t[2]; } u;
  u.v = *reinterpret_cast<const unsigned short*>(p);
  const unsigned lo = __float_as_uint(to_f32(u.t[0])) >> 16;
  const unsigned hi = __float_as_uint(to_f32(u.t[1])) >> 16;
  return lo | (hi << 16);
}

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ arguments

struct Args {
  const void* x;
  const void* w;
  const float* scales;  // QuantValues only
  const float* bias;    // may be null
  void* y;
  const int* seg;
  const int* col_seq;
  const int* tile_seq;
  const int* head_tile;  // (n_brows, 32): the first 32 tiles of each run
  const int* head_col;
  int M, K, N, n_brows, bn, bk, p_max, row_gran, act;
};

enum Instance { kGeneral = 0, kStream = 1, kFp32 = 2, kTc = 3 };

// ------------------------------------------------------ instance: stream

constexpr int STREAM_THREADS = 64;  // 2 warps: many small blocks even out SMs
constexpr int STREAM_VPC = 4;       // values of a tile row a lane reads

// An unsigned vector of N bytes (4, 8 or 16).
template <int N> struct VecOf;
template <> struct VecOf<4> { using T = unsigned; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<16> { using T = uint4; };

// A warp owns rw x NR rows of one block row: g = 32 / rw lanes share NR
// rows, lane c of them reading values 4c .. 4c + 3 of every tile row
// (bk <= 128), so the X values a lane loads serve NR rows. The run's first
// 32 tiles come from the head table, read at once beside seg (lane l: tile
// j0 + l); then TILES tiles at a time, the loads of their values (evict
// first: read once) and of X's columns (which stay in L1) are all in
// flight before the first FMA.
template <class VP, int MR, int NR, int TILES>
__global__ void __launch_bounds__(STREAM_THREADS, MR <= 8 ? 8 : 4)
plan_dds_stream(Args a) {
  using TX = typename VP::TX;
  using TW = typename VP::TW;
  constexpr int VPC = STREAM_VPC;
  using WV = typename VecOf<VPC * sizeof(TW)>::T;
  using XV = typename VecOf<VPC * sizeof(TX)>::T;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (STREAM_THREADS / 32) + threadIdx.x / 32;
  const int ch = a.bk / VPC;                   // lanes a tile row, <= 32
  const int rw = 1 << (31 - __clz(32 / ch));   // row groups a warp
  const int g = 32 / rw;                       // lanes a row group
  const int gpb = (a.bn + rw * NR - 1) / (rw * NR);  // warps a block row
  const int brow = warp / gpb;
  if (brow >= a.n_brows) return;               // whole warps only
  const int n0 = ((warp % gpb) * rw + lane / g) * NR;  // the group's rows
  const int c = lane & (g - 1);
  const bool lane_on = c < ch;
  // Loads are not branched around: a lane past bk reads its neighbour's
  // values and sums none (its zeros join the tree), a row past bn reads the
  // last row (its sums are never written), a tile past the run reads
  // another tile of the window or tile 0 (and is not summed).
  const int cv = min(c, ch - 1) * VPC;
  int woff[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) woff[r] = min(n0 + r, a.bn - 1) * a.bk + cv;
  const int64_t tile_elems = (int64_t)a.bn * a.bk;
  const TW* __restrict__ w = static_cast<const TW*>(a.w);
  const TX* __restrict__ x = static_cast<const TX*>(a.x) + cv;

  float acc[NR][MR];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0.f;

  const int j0 = a.seg[brow], j1 = a.seg[brow + 1];
  int my_t = a.head_tile[brow * 32 + lane];
  int my_col = a.head_col[brow * 32 + lane];
  for (int jw = j0; jw < j1; jw += 32) {
    const int jend = min(j1, jw + 32);
    if (jw != j0) {  // runs of more than 32 tiles
      const int jl = jw + lane;
      my_t = jl < jend ? a.tile_seq[jl] : 0;
      my_col = jl < jend ? a.col_seq[jl] : 0;
    }
    for (int jb = jw; jb < jend; jb += TILES) {
      WV wv[TILES][NR];
      XV xv[TILES][MR];
#pragma unroll
      for (int u = 0; u < TILES; ++u) {
        const int src = (jb - jw + u) & 31;
        const TW* wt = w + __shfl_sync(0xffffffffu, my_t, src) * tile_elems;
        const TX* xt = x + (int64_t)__shfl_sync(0xffffffffu, my_col, src) *
                               a.bk;
#pragma unroll
        for (int r = 0; r < NR; ++r)
          wv[u][r] = __ldcs(reinterpret_cast<const WV*>(wt + woff[r]));
#pragma unroll
        for (int m = 0; m < MR; ++m)
          if (m < a.M)
            xv[u][m] = __ldg(reinterpret_cast<const XV*>(
                xt + (int64_t)m * a.K));
      }
#pragma unroll
      for (int u = 0; u < TILES; ++u) {
        if (jb + u >= jend) break;
        float sc = 1.f;
        if constexpr (VP::kQuant)
          sc = VP::scale(a.scales,
                         __shfl_sync(0xffffffffu, my_t, (jb - jw + u) & 31),
                         a.p_max, a.row_gran);
        if (!lane_on) continue;
        float wf[NR][VPC];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          union { WV v; TW t[VPC]; } wu;
          wu.v = wv[u][r];
#pragma unroll
          for (int v = 0; v < VPC; ++v) wf[r][v] = to_f32(wu.t[v]);
        }
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (m >= a.M) continue;
          union { XV v; TX t[VPC]; } xu;
          xu.v = xv[u][m];
          float xf[VPC];
#pragma unroll
          for (int v = 0; v < VPC; ++v) xf[v] = to_f32(xu.t[v]);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            if constexpr (VP::kQuant) {
              float part = 0.f;
#pragma unroll
              for (int v = 0; v < VPC; ++v) part = fmaf(xf[v], wf[r][v], part);
              acc[r][m] = fmaf(sc, part, acc[r][m]);
            } else {
#pragma unroll
              for (int v = 0; v < VPC; ++v)
                acc[r][m] = fmaf(xf[v], wf[r][v], acc[r][m]);
            }
          }
        }
      }
    }
  }

  // fixed xor tree over the g lanes of a group: every lane ends with the
  // same bits (a + b == b + a), so any of them may write
  for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int m = 0; m < MR; ++m)
        acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (n0 + r >= a.bn) continue;
    const int n = brow * a.bn + n0 + r;
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m < a.M && ((r * MR + m) & (g - 1)) == c)
        write_out(static_cast<TX*>(a.y), (int64_t)m * a.N + n, acc[r][m],
                  a.bias, n, a.act);
  }
}

// ---------------------------------------- the ring of fp32 and tc instances

constexpr int RING_BN = 64;       // output columns a block (of a block row)

// bytes of one staged row of `row_bytes`: a 16-byte multiple, padded so the
// fragment reads of neighbouring rows fall in other banks
__host__ __device__ constexpr int ring_pitch(int row_bytes) {
  return row_bytes + 16 > 48 ? row_bytes + 16 : 48;
}

template <typename TX, typename TW, int BK, int BM>
struct Ring {
  static constexpr int XP = ring_pitch(BK * (int)sizeof(TX));
  static constexpr int WP = ring_pitch(BK * (int)sizeof(TW));
  static constexpr int STAGE = BM * XP + RING_BN * WP;
};

// Stages slabs (tile t, depth k0 .. k0 + kv) of X's rows m0.. and of the
// tile's rows c0.. into a stage of the ring: 16-byte cp.async, rows past M
// or bn filled with zeros. Each thread copies the same chunks of every slab,
// so their offsets are worked out once.
template <typename TX, typename TW, int BK, int BM, int THREADS>
struct SlabLoader {
  using R = Ring<TX, TW, BK, BM>;
  static constexpr int EX = 16 / (int)sizeof(TX), EW = 16 / (int)sizeof(TW);
  static constexpr int XCH = BK / EX, WCH = BK / EW;  // chunks a staged row
  static constexpr int NX = (BM * XCH + THREADS - 1) / THREADS;
  static constexpr int NW = (RING_BN * WCH + THREADS - 1) / THREADS;
  int64_t xo[NX];     // the chunk in X, less the slab's first column
  int xd[NX], xk[NX]; // byte offset in the stage (-1: none); depth
  bool xok[NX];
  int wo[NW], wd[NW], wk[NW];
  bool wok[NW];

  __device__ __forceinline__ SlabLoader(const Args& a, int m0, int c0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / XCH, cc = idx % XCH;
      xok[i] = m0 + r < a.M;
      xo[i] = (xok[i] ? (int64_t)(m0 + r) * a.K : 0) + cc * EX;
      xd[i] = idx < BM * XCH ? r * R::XP + cc * 16 : -1;
      xk[i] = cc * EX;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / WCH, cc = idx % WCH;
      wok[i] = c0 + r < a.bn;
      wo[i] = (wok[i] ? (c0 + r) * a.bk : 0) + cc * EW;
      wd[i] = idx < RING_BN * WCH ? BM * R::XP + r * R::WP + cc * 16
                                  : -1;
      wk[i] = cc * EW;
    }
  }

  __device__ __forceinline__ void load(unsigned char* stage, const Args& a,
                                       int t, int col, int k0, int kv) const {
    const TX* x = static_cast<const TX*>(a.x) + (int64_t)col * a.bk + k0;
    const TW* w = static_cast<const TW*>(a.w) +
                  (int64_t)t * a.bn * a.bk + k0;
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (xd[i] >= 0 && xk[i] < kv)
        cp_async16(stage + xd[i], x + xo[i], xok[i]);
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (wd[i] >= 0 && wk[i] < kv)
        cp_async16(stage + wd[i], w + wo[i], wok[i]);
  }
};

// The (tile, slab) sequence of block row brow's run, through a STAGES-deep
// ring: slab s is waited for, the slab STAGES - 1 ahead is issued into the
// stage that slab s - 1 used (free once every thread passed the barrier),
// then `compute(stage, kv)` consumes slab s and, after a tile's last slab,
// `end_tile(t)` folds it in.
template <typename TX, typename TW, int BK, int BM, int STAGES, int THREADS,
          class Compute, class EndTile>
__device__ __forceinline__ void ring_walk(const Args& a, unsigned char* smem,
                                          int brow, int m0, int c0,
                                          Compute&& compute,
                                          EndTile&& end_tile) {
  using R = Ring<TX, TW, BK, BM>;
  const SlabLoader<TX, TW, BK, BM, THREADS> loader(a, m0, c0);
  const int j0 = a.seg[brow], j1 = a.seg[brow + 1];
  const int spt = (a.bk + BK - 1) / BK;  // slabs a tile
  const int n_slabs = (j1 - j0) * spt;
  // the slab to issue next, as (tile of the run, depth)
  int ij = j0, ik = 0, it = j0 < j1 ? a.tile_seq[j0] : 0;
  int ic = j0 < j1 ? a.col_seq[j0] : 0;
  int issued = 0;
  auto issue = [&]() {
    if (issued < n_slabs) {
      loader.load(smem + (issued % STAGES) * R::STAGE, a, it, ic, ik,
                  min(BK, a.bk - ik));
      ik += BK;
      if (ik >= a.bk) {
        ik = 0;
        if (++ij < j1) {
          it = a.tile_seq[ij];
          ic = a.col_seq[ij];
        }
      }
      ++issued;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();
  // the slab to consume, as (tile of the run, depth)
  int cj = j0, ck = 0;
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue();
    compute(smem + (s % STAGES) * R::STAGE, min(BK, a.bk - ck));
    ck += BK;
    if (ck >= a.bk) {
      end_tile(a.tile_seq[cj]);
      ck = 0;
      ++cj;
    }
  }
  cp_async_wait<0>();
}

// -------------------------------------------------------- instance: fp32

constexpr int FP32_BK = 16;
constexpr int FP32_STAGES = 4;
constexpr int FP32_BM = 64;                          // rows of X a block
constexpr int FP32_THREADS = 128;
constexpr int FP32_TN = 4;                           // columns a thread
constexpr int FP32_NT = RING_BN / FP32_TN;           // threads along n
constexpr int FP32_MT = FP32_THREADS / FP32_NT;      // threads along m
constexpr int FP32_TM = FP32_BM / FP32_MT;           // rows a thread

// thread (tm, tn) = (tid / NT, tid % NT) owns rows tm + MT i (i < TM) and
// columns tn + NT q (q < TN) of the block's BM x 64 outputs
template <class VP>
__global__ void __launch_bounds__(FP32_THREADS, 1)
plan_dds_fp32(Args a, int n_chunks) {
  using TX = typename VP::TX;
  using TW = typename VP::TW;
  using R = Ring<TX, TW, FP32_BK, FP32_BM>;
  extern __shared__ __align__(16) unsigned char plan_smem[];
  const int brow = blockIdx.x / n_chunks;
  const int c0 = (blockIdx.x % n_chunks) * RING_BN;
  const int m0 = blockIdx.y * FP32_BM;
  const int tm = threadIdx.x / FP32_NT, tn = threadIdx.x % FP32_NT;
  constexpr int TM = FP32_TM, TN = FP32_TN;

  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = part[i][q] = 0.f;

  auto compute = [&](const unsigned char* stage, int) {
    const unsigned char* xs = stage;
    const unsigned char* ws = stage + FP32_BM * R::XP;
#pragma unroll
    for (int k4 = 0; k4 < FP32_BK; k4 += 4) {
      float xa[TM][4], wb[TN][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        smem_f32x4(reinterpret_cast<const TX*>(
                       xs + (tm + FP32_MT * i) * R::XP) + k4, xa[i]);
#pragma unroll
      for (int q = 0; q < TN; ++q)
        smem_f32x4(reinterpret_cast<const TW*>(
                       ws + (tn + FP32_NT * q) * R::WP) + k4, wb[q]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) {
            if constexpr (VP::kQuant)
              part[i][q] = fmaf(xa[i][kk], wb[q][kk], part[i][q]);
            else
              acc[i][q] = fmaf(xa[i][kk], wb[q][kk], acc[i][q]);
          }
    }
  };
  auto end_tile = [&](int t) {
    if constexpr (VP::kQuant) {
      const float s = VP::scale(a.scales, t, a.p_max, a.row_gran);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) {
          acc[i][q] = fmaf(s, part[i][q], acc[i][q]);
          part[i][q] = 0.f;
        }
    }
  };
  ring_walk<TX, TW, FP32_BK, FP32_BM, FP32_STAGES, FP32_THREADS>(
      a, plan_smem, brow, m0, c0, compute, end_tile);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + FP32_MT * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int cl = c0 + tn + FP32_NT * q;
      if (cl >= a.bn) continue;
      const int n = brow * a.bn + cl;
      write_out(static_cast<TX*>(a.y), (int64_t)m * a.N + n, acc[i][q],
                a.bias, n, a.act);
    }
  }
}

// ---------------------------------------------------------- instance: tc

constexpr int TC_BK = 32;
constexpr int TC_STAGES = 6;
constexpr int TC_BM = 64;                    // rows of X a block
constexpr int TC_THREADS = TC_BM / 32 * 64;  // warps of 32 x 32 outputs

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// warp (wm, wn) = (warp / 2, warp % 2) owns rows wm * 32 .. + 31 and columns
// wn * 32 .. + 31 of the block's 64 x 64 outputs: 2 x 4 fragments of 16 x 8
template <class VP>
__global__ void __launch_bounds__(TC_THREADS, 1)
plan_dds_tc(Args a, int n_chunks) {
  using TX = typename VP::TX;
  using TW = typename VP::TW;
  static_assert(sizeof(TX) == 2, "tc takes bf16 x");
  using R = Ring<TX, TW, TC_BK, TC_BM>;
  extern __shared__ __align__(16) unsigned char plan_smem[];
  const int brow = blockIdx.x / n_chunks;
  const int c0 = (blockIdx.x % n_chunks) * RING_BN;
  const int m0 = blockIdx.y * TC_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wm = warp / 2, wn = warp % 2;  // 32-row band, 32-column half
  const int gid = lane / 4, tig = lane % 4;

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = part[i][q][e] = 0.f;

  auto compute = [&](const unsigned char* stage, int kv) {
    const unsigned char* xs = stage;
    const unsigned char* ws = stage + TC_BM * R::XP;
    for (int ks = 0; ks < kv / 16; ++ks) {
      unsigned fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + gid;
        const int k = ks * 16 + 2 * tig;
        const TX* lo = reinterpret_cast<const TX*>(xs + r * R::XP);
        const TX* hi = reinterpret_cast<const TX*>(xs + (r + 8) * R::XP);
        fa[i][0] = *reinterpret_cast<const unsigned*>(lo + k);
        fa[i][1] = *reinterpret_cast<const unsigned*>(hi + k);
        fa[i][2] = *reinterpret_cast<const unsigned*>(lo + k + 8);
        fa[i][3] = *reinterpret_cast<const unsigned*>(hi + k + 8);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = wn * 32 + q * 8 + gid;
        const TW* row = reinterpret_cast<const TW*>(ws + n * R::WP);
        fb[q][0] = bf16_pair(row + ks * 16 + 2 * tig);
        fb[q][1] = bf16_pair(row + ks * 16 + 2 * tig + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (VP::kQuant)
            mma_bf16(part[i][q], fa[i], fb[q]);
          else
            mma_bf16(acc[i][q], fa[i], fb[q]);
        }
    }
  };
  auto end_tile = [&](int t) {
    if constexpr (VP::kQuant) {
      const float s = VP::scale(a.scales, t, a.p_max, a.row_gran);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][q][e] = fmaf(s, part[i][q][e], acc[i][q][e]);
            part[i][q][e] = 0.f;
          }
    }
  };
  ring_walk<TX, TW, TC_BK, TC_BM, TC_STAGES, TC_THREADS>(
      a, plan_smem, brow, m0, c0, compute, end_tile);

  // fragment element e of (i, q): row gid (+ 8 for e >= 2), column
  // 2 tig + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm * 32 + i * 16 + gid + (e >= 2 ? 8 : 0);
      if (m >= a.M) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cl = c0 + wn * 32 + q * 8 + 2 * tig + (e & 1);
        if (cl >= a.bn) continue;
        const int n = brow * a.bn + cl;
        write_out(static_cast<TX*>(a.y), (int64_t)m * a.N + n, acc[i][q][e],
                  a.bias, n, a.act);
      }
    }
}

// ----------------------------------------------------- instance: general

constexpr int GEN_BM = 64;
constexpr int GEN_BN = 64;
constexpr int GEN_BKC = 16;
constexpr int GEN_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <class VP>
__global__ void __launch_bounds__(GEN_THREADS, 1)
plan_dds_general(Args a, int n_chunks) {
  using TX = typename VP::TX;
  using TW = typename VP::TW;
  __shared__ float xs[GEN_BKC][GEN_BM + 1];
  __shared__ float ws[GEN_BKC][GEN_BN + 1];
  const TX* __restrict__ x = static_cast<const TX*>(a.x);
  const TW* __restrict__ w = static_cast<const TW*>(a.w);

  const int m0 = blockIdx.x * GEN_BM;
  const int brow = blockIdx.y / n_chunks;
  const int c0 = (blockIdx.y % n_chunks) * GEN_BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;        // compute lanes
  const int lk = tid % GEN_BKC, lr = tid / GEN_BKC;  // load lanes

  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = part[i][q] = 0.f;

  const int j0 = a.seg[brow], j1 = a.seg[brow + 1];
  for (int j = j0; j < j1; ++j) {
    const int t = a.tile_seq[j];
    const int64_t xcol = (int64_t)a.col_seq[j] * a.bk;
    const TW* wt = w + (int64_t)t * a.bn * a.bk;
    for (int k0 = 0; k0 < a.bk; k0 += GEN_BKC) {
      const int kk = k0 + lk;
      const bool kin = kk < a.bk;
#pragma unroll
      for (int i = 0; i < GEN_BM / 16; ++i) {
        const int r = lr + 16 * i;
        const int m = m0 + r;
        xs[lk][r] = (kin && m < a.M) ? to_f32(x[(int64_t)m * a.K + xcol + kk])
                                     : 0.f;
      }
#pragma unroll
      for (int i = 0; i < GEN_BN / 16; ++i) {
        const int cl = lr + 16 * i;
        const int n = c0 + cl;
        ws[lk][cl] = (kin && n < a.bn) ? to_f32(wt[(int64_t)n * a.bk + kk])
                                       : 0.f;
      }
      __syncthreads();
      const int kmax = min(GEN_BKC, a.bk - k0);
      for (int k = 0; k < kmax; ++k) {
        float xa[4], wb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = xs[k][ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) wb[q] = ws[k][tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (VP::kQuant)
              part[i][q] = fmaf(xa[i], wb[q], part[i][q]);
            else
              acc[i][q] = fmaf(xa[i], wb[q], acc[i][q]);
          }
      }
      __syncthreads();
    }
    if constexpr (VP::kQuant) {
      const float s = VP::scale(a.scales, t, a.p_max, a.row_gran);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q] = fmaf(s, part[i][q], acc[i][q]);
          part[i][q] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cl = c0 + tx + 16 * q;
      if (cl >= a.bn) continue;
      const int n = brow * a.bn + cl;
      write_out(static_cast<TX*>(a.y), (int64_t)m * a.N + n, acc[i][q],
                a.bias, n, a.act);
    }
  }
}

// ------------------------------------------------------------- launching

// Dynamic shared memory an instance needs: the ring's stages (bsr_matmul.
// plan_smem_bytes computes the same on the host).
template <class VP>
constexpr int smem_need(int instance) {
  using TX = typename VP::TX;
  using TW = typename VP::TW;
  return instance == kFp32
             ? FP32_STAGES * Ring<TX, TW, FP32_BK, FP32_BM>::STAGE
         : instance == kTc ? TC_STAGES * Ring<TX, TW, TC_BK, TC_BM>::STAGE
                           : 0;
}

// Raise a kernel's dynamic shared memory limit to `bytes` where it exceeds
// the 48 KB default, once a device and size. A refusal (more than the card
// offers) is returned, and the launch is not made.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&configured)[16]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && configured[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch's check is its own
    return e;
  }
  if (dev < 16) configured[dev] = bytes;
  return cudaSuccess;
}

template <class VP, int I>
int smem_configured[16] = {};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch `instance` over the arguments; returns a CUDA error code (0 when
// the launch was accepted). Anything the instance cannot take is refused with
// cudaErrorInvalidValue before a launch.
template <class VP>
int launch(const Args& a, int instance, int smem, cudaStream_t stream) {
  using TX = typename VP::TX;
  using TW = typename VP::TW;
  if (a.M <= 0 || a.n_brows <= 0 || a.bn <= 0 || a.bk <= 0 ||
      (VP::kQuant && a.p_max <= 0))
    return (int)cudaErrorInvalidConfiguration;
  if (instance == kGeneral) {
    const int n_chunks = (a.bn + GEN_BN - 1) / GEN_BN;
    const long long gy = (long long)a.n_brows * n_chunks;
    if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((a.M + GEN_BM - 1) / GEN_BM, (unsigned)gy);
    plan_dds_general<VP><<<grid, GEN_THREADS, 0, stream>>>(a, n_chunks);
    return (int)cudaGetLastError();
  }
  // the vector instances: 16-byte rows of 16-deep chunks, 8-row fragments
  if (a.bk % 16 != 0 || a.bn % 8 != 0 || !aligned16(a.x) || !aligned16(a.w) ||
      smem < smem_need<VP>(instance))
    return (int)cudaErrorInvalidValue;
  if (instance == kStream) {
    if (a.M > 16 || a.bk > 32 * STREAM_VPC) return (int)cudaErrorInvalidValue;
    const int ch = a.bk / STREAM_VPC;
    int rw = 1;
    while (rw * 2 * ch <= 32) rw *= 2;
    // Rows a lane group, and tiles in flight a warp: their X columns are
    // held in registers, 32 a lane (M rows of 4 values a tile).
    constexpr int NR = 2, XR = STREAM_VPC * (int)sizeof(TX) / 4;
    constexpr int T4 = 32 / (4 * XR), T8 = 32 / (8 * XR);
    const long long warps = (long long)a.n_brows *
                            ((a.bn + rw * NR - 1) / (rw * NR));
    const long long blocks = (warps + STREAM_THREADS / 32 - 1) /
                             (STREAM_THREADS / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (a.M <= 4)
      plan_dds_stream<VP, 4, NR, T4>
          <<<(unsigned)blocks, STREAM_THREADS, 0, stream>>>(a);
    else if (a.M <= 8)
      plan_dds_stream<VP, 8, NR, T8>
          <<<(unsigned)blocks, STREAM_THREADS, 0, stream>>>(a);
    else
      plan_dds_stream<VP, 16, NR, 1>
          <<<(unsigned)blocks, STREAM_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int n_chunks = (a.bn + RING_BN - 1) / RING_BN;
  const long long gx = (long long)a.n_brows * n_chunks;
  const int bm = instance == kTc ? TC_BM : FP32_BM;
  const long long gy = (a.M + bm - 1) / bm;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (instance == kFp32) {
    cudaError_t e = allow_smem(plan_dds_fp32<VP>, smem,
                               smem_configured<VP, kFp32>);
    if (e != cudaSuccess) return (int)e;
    plan_dds_fp32<VP><<<grid, FP32_THREADS, smem, stream>>>(a, n_chunks);
    return (int)cudaGetLastError();
  }
  if (instance == kTc) {
    if constexpr (sizeof(TX) == 2 && sizeof(TW) <= 2) {
      cudaError_t e = allow_smem(plan_dds_tc<VP>, smem,
                                 smem_configured<VP, kTc>);
      if (e != cudaSuccess) return (int)e;
      plan_dds_tc<VP><<<grid, TC_THREADS, smem, stream>>>(a, n_chunks);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace plan_dds
