// K2 and K3: split-parallel flash-decode attention, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of kernels/flash_decode.py:
//   K2 flash_decode_split_kernel + flash_decode_combine_kernel
//        <- _flash_decode_call (body _flash_decode_kernel)
//   K3 paged_flash_decode_split_kernel + paged_flash_decode_combine_kernel
//        <- _paged_flash_call  (same body, one split a page)
//
// Both compute, for one decode step, for every request slot b and query head,
//
//     out = softmax_t(q . k_t * D^-0.5 over the visible t) @ V
//
// where slot t of the cache is visible iff its stored position kvp satisfies
// kvp >= 0 && kvp <= pos[b] (&& kvp > pos[b] - window for ring caches). K2
// reads the dense (B, T, Hkv, D) caches, K3 the (n_pages, page_size, Hkv, D)
// pools through the (B, NP) page table (-1 = unmapped, clipped to page 0; its
// lanes are masked by pos_map).
//
// Design. The TPU grid (B, Hkv, num_split) walks the splits of the KV axis in
// order and carries the online-softmax state (m, l, acc) in VMEM scratch.
// Here the same splits, in the same order, take two launches:
//
//   1. split kernel: one block per (split s, KV head h, slot b) with the G
//      query rows of head h. It scores the split's visible rows, takes the
//      split's own max M_s (NEG_INF when no row is visible), forms
//      p = exp(s - M_s) (0 on masked rows, which are never loaded) and writes
//      the partial (M_s, l_s = sum p, acc_s = sum p * v), all fp32, into the
//      workspace. Every block writes its partial, also for an empty or fully
//      masked split: (NEG_INF, 0, 0).
//   2. combine kernel: one thread per (b, h, g, d) folds s = 0 .. S-1 in
//      order with a running (m, l, acc): m' = max(m, M_s), a = exp(m - m'),
//      c = exp(M_s - m'), l = l a + l_s c, acc = acc a + acc_s c; then
//      out = acc / max(l, 1e-30) in q's dtype.
//
// That is the reference's per-split fold with each split taken against its
// own max and rescaled once in the combine: relative to it, a split adds one
// fp32 rounding of exp(M_s - m') and one multiply. NEG_INF is the finite
// -1e30, so exp(NEG_INF - NEG_INF) = 1 and a neutral split's zero l_s and
// acc_s keep its contribution at exactly zero; an inactive slot (pos = -1)
// gives exact zeros. No atomics and a fixed order everywhere, so two calls on
// the same inputs are bitwise equal. Every split of K2 and K3 runs one device
// routine (split_partial), chosen from the same (G, rows per split), and both
// share one combine routine, so K3 is bit-exact against K2 over the gathered
// dense view when the split boundaries match (one split = one page).
//
// Inside a split block (8 warps; 4 for splits of at most 16 rows, such as
// K3's pages): a warp owns every NW-th row of the split; its lanes read a
// row in 16-byte vectors (8 bf16 or 4 fp32 a lane, so at D = 256 in bf16 one
// instruction reads the whole row), with R rows in flight at once. The
// positions of a chunk's rows are read first, so a warp issues only the
// loads of visible rows. The G scores of a row are lane dot products against
// q (read the same way, from L1) reduced by butterfly shuffles, and are kept
// in shared memory, so K is read once. A split whose G * rows scores do not
// fit (SC_MAX floats; e.g. kv_split=1 on a long cache) goes in chunks of rows
// in two passes, a first for the max and a second that scores the chunk
// again. For the value product each lane keeps fp32 accumulators for up to
// GB query rows over its 8 elements of D; the warps' partial sums meet in
// shared memory and are added in warp order. Short splits keep their V rows
// in registers from the K loads on. The instance (warps, R, GB) is chosen
// from (G, rows a split), so K2 and K3 pick the same one for the same split.
//
// What bounds it. The work is a few FLOPs per cache byte, so the limit is
// device memory: per call the K and V rows of the visible positions
// (2 * visible * Hkv * D * bytes), the position maps, q and out. The
// workspace (S * B * Hkv * G * (D + 2) fp32) is written once and read once by
// the combine, mostly from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_MAX = 8;          // split kernel: warps of the widest instance
constexpr int COMBINE_THREADS = 128;  // combine kernel: one (g, d) a thread
constexpr int DMAX = 256;             // largest head dim
constexpr int GMAX = 16;              // largest query group (Hq / Hkv)
constexpr int GB_MAX = 4;             // query rows a value pass accumulates
constexpr int EPL = 8;                // elements of D a lane holds (D = 256)
constexpr int SC_MAX = 8192;          // fp32 scores a block keeps
constexpr int CH_MAX = 1024;          // rows a chunk holds at most
constexpr int COMBINE_CHUNK = 32;     // splits a combine block stages at once
constexpr float NEG_INF = -1e30f;

// A row is read in 16-byte chunks: E elements each, CPL chunks a lane at
// D = 256, R rows in flight a warp on long splits.
template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int E = 4, CPL = 2, R = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  // the chunk at element d0 of an unaligned row, zero past D
  __device__ __forceinline__ static uint4 gather(const float* row, int d0,
                                                 int D) {
    const unsigned* r = reinterpret_cast<const unsigned*>(row);
    uint4 u;
    u.x = d0 < D ? r[d0] : 0u;
    u.y = d0 + 1 < D ? r[d0 + 1] : 0u;
    u.z = d0 + 2 < D ? r[d0 + 2] : 0u;
    u.w = d0 + 3 < D ? r[d0 + 3] : 0u;
    return u;
  }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int E = 8, CPL = 1, R = 8;
  // bf16 is the top half of an fp32: element 2i is the low half of word i
  __device__ __forceinline__ static void pair(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    pair(u.x, f);
    pair(u.y, f + 2);
    pair(u.z, f + 4);
    pair(u.w, f + 6);
  }
  __device__ __forceinline__ static uint4 gather(const __nv_bfloat16* row,
                                                 int d0, int D) {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + 2 * i;
      const unsigned lo = d < D ? r[d] : 0u, hi = d + 1 < D ? r[d + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// A split kernel instance: NW warps, R rows in flight a warp, GB query rows
// a value pass accumulates, and KEEP_V: the V rows stay in registers from the
// K loads on (a warp's rows of a chunk fit one batch of R).
template <int NW_, int R_, int GB_, bool KEEP_V_>
struct Cfg {
  static constexpr int NW = NW_, THREADS = 32 * NW_, R = R_, GB = GB_;
  static constexpr bool KEEP_V = KEEP_V_;
};
// short splits (K3's 16-row pages): 4 warps of at most 4 rows, one batch
template <int GB>
using Narrow = Cfg<4, 4, GB, true>;
template <typename T, int GB>
using Wide = Cfg<WARPS_MAX, Traits<T>::R, GB, false>;

template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int D,
                                            bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row) + c);
  return Traits<T>::gather(row, c * Traits<T>::E, D);
}

__device__ __forceinline__ bool visible(int kvp, int pos, int window) {
  bool ok = kvp >= 0 && kvp <= pos;
  if (window > 0) ok = ok && kvp > pos - window;
  return ok;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Rows a chunk of a split holds: the split's rows if G of them fit, else
// the most that fit. K2 and K3 pass the same rows per split (ck = page
// size), so they chunk alike.
__host__ __device__ inline int chunk_rows(int G, int ck) {
  int ch = SC_MAX / G;
  ch = ch < CH_MAX ? ch : CH_MAX;
  return ck < ch ? ck : ch;
}

__host__ __device__ inline int padded_d(int D, int E) {
  return (D + E - 1) / E * E;
}

// Dynamic shared memory of a split block, fp32 unless noted: scores /
// probabilities (G * CHr), the warps' value partials (NW * min(G, GB) * DP),
// the running max and sum (GMAX each), then the rows' visibility (CHr ints).
__host__ __device__ inline size_t smem_bytes(int G, int D, int CHr, int E,
                                             int GB, int NW) {
  const int DP = padded_d(D, E), GBe = G < GB ? G : GB;
  return sizeof(float) * ((size_t)G * CHr + (size_t)NW * GBe * DP +
                          2 * GMAX) +
         sizeof(int) * (size_t)CHr;
}

size_t max_smem_bytes() {
  size_t most = 0;
  for (int G = 1; G <= GMAX; ++G) {
    const size_t b =
        smem_bytes(G, DMAX, chunk_rows(G, CH_MAX), 4, GB_MAX, WARPS_MAX);
    most = b > most ? b : most;
  }
  return most;
}

struct Smem {
  float* sc;
  float* red;
  float* mx;
  float* ls;
  int* ok;
};

// ok[j] for rows [j0, j0 + cnt) of the split, all positions at once.
template <typename C, typename Rows>
__device__ __forceinline__ void mark_chunk(const Smem& sh, const Rows& rows,
                                           int j0, int cnt, int pos,
                                           int window) {
  for (int j = threadIdx.x; j < cnt; j += C::THREADS)
    sh.ok[j] = visible(rows.kvp(j0 + j), pos, window);
}

// Score rows [j0, j0 + cnt) of the split (ok[] marked): sc[g * CHr + j] =
// q_g . k_j * scale, NEG_INF for a masked row, which is not loaded. With
// KEEP_V (a warp's rows of the chunk fit one batch of R) the V rows are
// loaded beside the K rows and kept in vraw for chunk_values.
template <typename T, typename C, bool KEEP_V, typename Rows>
__device__ __forceinline__ void score_chunk(
    const Smem& sh, const Rows& rows, const T* __restrict__ q, int j0,
    int cnt, int CHr, int G, int D, int NC, bool vec, bool vecq, float scale,
    uint4 (&vraw)[C::R][Traits<T>::CPL]) {
  using TR = Traits<T>;
  constexpr int E = TR::E, CPL = TR::CPL, R = C::R, NW = C::NW;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k0 = warp; k0 < cnt; k0 += NW * R) {
    uint4 raw[R][CPL];
    bool vis[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = k0 + r * NW;
      vis[r] = j < cnt && sh.ok[j];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        const bool load = vis[r] && c < NC;
        raw[r][i] = load ? load_chunk(rows.k_row(j0 + j), c, D, vec)
                         : make_uint4(0u, 0u, 0u, 0u);
        if (KEEP_V)
          vraw[r][i] = load ? load_chunk(rows.v_row(j0 + j), c, D, vec)
                            : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int g = 0; g < G; ++g) {
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c >= NC) continue;
        float qv[E];
        TR::unpack(load_chunk(q + g * D, c, D, vecq), qv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float kf[E];
          TR::unpack(raw[r][i], kf);
#pragma unroll
          for (int e = 0; e < E; ++e) part[r] += qv[e] * kf[e];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = warp_sum(part[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = k0 + r * NW;
          if (j < cnt) sh.sc[g * CHr + j] = vis[r] ? part[r] * scale : NEG_INF;
        }
      }
    }
  }
}

// Fold the chunk's max into mx[g] (a warp per query row).
template <int NW>
__device__ __forceinline__ void chunk_max(const Smem& sh, int cnt, int CHr,
                                          int G) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int g = warp; g < G; g += NW) {
    float m = NEG_INF;
    for (int j = lane; j < cnt; j += 32) m = fmaxf(m, sh.sc[g * CHr + j]);
    m = warp_max(m);
    if (lane == 0) sh.mx[g] = fmaxf(sh.mx[g], m);
  }
}

// Scores -> p = exp(s - M_s) in place (0 on masked rows); ls[g] += sum p.
template <int NW>
__device__ __forceinline__ void chunk_probs(const Smem& sh, int cnt, int CHr,
                                            int G) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int g = warp; g < G; g += NW) {
    const float m = sh.mx[g];
    float sum = 0.f;
    for (int j = lane; j < cnt; j += 32) {
      const float p = sh.ok[j] ? expf(sh.sc[g * CHr + j] - m) : 0.f;
      sh.sc[g * CHr + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) sh.ls[g] += sum;
  }
}

// acc[g, :] (+)= sum_j p[g, j] * v_j over the chunk's visible rows; the
// first chunk writes, later chunks add. With KEEP_V the V rows are the ones
// score_chunk left in vraw.
template <typename T, typename C, typename Rows>
__device__ __forceinline__ void chunk_values(
    const Smem& sh, const Rows& rows, int j0, int cnt, int CHr, int G, int D,
    int NC, int DP, bool vec, bool first, float* __restrict__ acc_out,
    const uint4 (&vraw)[C::R][Traits<T>::CPL]) {
  using TR = Traits<T>;
  constexpr int E = TR::E, CPL = TR::CPL, R = C::R, GB = C::GB, NW = C::NW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int GBe = G < GB ? G : GB;
  for (int g0 = 0; g0 < G; g0 += GB) {
    const int ng = min(GB, G - g0);
    float acc[GB][EPL];
#pragma unroll
    for (int gb = 0; gb < GB; ++gb)
#pragma unroll
      for (int x = 0; x < EPL; ++x) acc[gb][x] = 0.f;
    for (int k0 = warp; k0 < cnt; k0 += NW * R) {
      uint4 raw[R][CPL];
      bool use[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = k0 + r * NW;
        use[r] = j < cnt && sh.ok[j];
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (C::KEEP_V)
            raw[r][i] = vraw[r][i];
          else
            raw[r][i] = use[r] && c < NC
                            ? load_chunk(rows.v_row(j0 + j), c, D, vec)
                            : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!use[r]) continue;                 // uniform across the warp
        const int j = k0 + r * NW;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          float vf[E];
          TR::unpack(raw[r][i], vf);
#pragma unroll
          for (int gb = 0; gb < GB; ++gb) {
            if (gb < ng) {
              const float p = sh.sc[(g0 + gb) * CHr + j];
#pragma unroll
              for (int e = 0; e < E; ++e) acc[gb][i * E + e] += p * vf[e];
            }
          }
        }
      }
    }
    // the warps' partials meet in shared memory, added in warp order
#pragma unroll
    for (int gb = 0; gb < GB; ++gb) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (gb < ng && c < NC) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            sh.red[(warp * GBe + gb) * DP + c * E + e] = acc[gb][i * E + e];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < ng * D; idx += C::THREADS) {
      const int gb = idx / D, d = idx - gb * D;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += sh.red[(w * GBe + gb) * DP + d];
      float* dst = acc_out + (size_t)(g0 + gb) * D + d;
      *dst = first ? s : *dst + s;
    }
    __syncthreads();
  }
}

// One split of n rows (n may be 0) -> its partial (M_s, l_s, acc_s) at
// part_m[g], part_l[g], part_acc[g * D + d].
// (vec: bit 0 for 16-byte loads of the K / V rows, bit 1 for q's.)
template <typename T, typename C, typename Rows>
__device__ void split_partial(float* smem, const Rows& rows,
                              const T* __restrict__ q, int n, int CHr,
                              int pos, int window, int G, int D, int vec,
                              float* __restrict__ part_m,
                              float* __restrict__ part_l,
                              float* __restrict__ part_acc) {
  constexpr int E = Traits<T>::E, NW = C::NW;
  const int NC = (D + E - 1) / E, DP = NC * E;
  const int GBe = G < C::GB ? G : C::GB;
  const bool vkv = vec & 1, vq = vec & 2;
  Smem sh;
  sh.sc = smem;
  sh.red = sh.sc + G * CHr;
  sh.mx = sh.red + NW * GBe * DP;
  sh.ls = sh.mx + GMAX;
  sh.ok = reinterpret_cast<int*>(sh.ls + GMAX);
  const int tid = threadIdx.x;
  if (tid < G) {            // read after the first scores' barrier
    sh.mx[tid] = NEG_INF;
    sh.ls[tid] = 0.f;
  }

  const float scale = rsqrtf((float)D);
  const int nch = (n + CHr - 1) / CHr;
  // V rows kept from the K loads on (C::KEEP_V), which saves a round trip
  uint4 vraw[C::R][Traits<T>::CPL] = {};
  if (nch > 1) {            // pass 1 over a long split: the max, chunk by chunk
    for (int c = 0; c < nch; ++c) {
      const int j0 = c * CHr, cnt = min(CHr, n - j0);
      mark_chunk<C>(sh, rows, j0, cnt, pos, window);
      __syncthreads();
      score_chunk<T, C, false>(sh, rows, q, j0, cnt, CHr, G, D, NC, vkv, vq,
                               scale, vraw);
      __syncthreads();
      chunk_max<NW>(sh, cnt, CHr, G);
      __syncthreads();
    }
  }
  for (int c = 0; c < nch; ++c) {
    const int j0 = c * CHr, cnt = min(CHr, n - j0);
    mark_chunk<C>(sh, rows, j0, cnt, pos, window);
    __syncthreads();
    score_chunk<T, C, C::KEEP_V>(sh, rows, q, j0, cnt, CHr, G, D, NC, vkv, vq,
                                 scale, vraw);
    __syncthreads();
    if (nch == 1) {         // the scores stay in shared memory: K read once
      chunk_max<NW>(sh, cnt, CHr, G);
      __syncthreads();
    }
    chunk_probs<NW>(sh, cnt, CHr, G);
    __syncthreads();
    chunk_values<T, C>(sh, rows, j0, cnt, CHr, G, D, NC, DP, vkv, c == 0,
                       part_acc, vraw);
  }
  if (nch == 0)             // an empty split: the neutral partial
    for (int i = tid; i < G * D; i += C::THREADS) part_acc[i] = 0.f;
  if (tid < G) {
    part_m[tid] = sh.mx[tid];
    part_l[tid] = sh.ls[tid];
  }
}

// Fold the S partials of one (b, h) in split order; thread = (g, d). The
// running max m_s = max(m_{s-1}, M_s) is a prefix max, exact in any order,
// so a warp per query row scans COMBINE_CHUNK splits at once and stages
// a_s = exp(m_{s-1} - m_s) and c_s = exp(M_s - m_s) in shared memory; each
// thread then runs l = l a_s + l_s c_s, acc = acc a_s + acc_s c_s over the
// chunk in order: the sequential fold's values, bit for bit.
template <typename T>
__device__ __forceinline__ void combine(const float* __restrict__ ws_m,
                                        const float* __restrict__ ws_l,
                                        const float* __restrict__ ws_acc,
                                        T* __restrict__ out, int S, int G,
                                        int D) {
  __shared__ float fa[COMBINE_CHUNK][GMAX], fc[COMBINE_CHUNK][GMAX];
  __shared__ float carry[GMAX];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int idx = blockIdx.y * COMBINE_THREADS + tid;
  const bool active = idx < G * D;
  const int g = active ? idx / D : 0;
  const float* pm = ws_m + (size_t)bh * S * G;
  const float* pl = ws_l + (size_t)bh * S * G + g;
  const float* pa = ws_acc + (size_t)bh * S * G * D + (active ? idx : 0);
  if (tid < G) carry[tid] = NEG_INF;
  float l = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < S; s0 += COMBINE_CHUNK) {
    __syncthreads();        // carry set, the last chunk's factors consumed
    for (int gg = warp; gg < G; gg += COMBINE_THREADS / 32) {
      const int s = s0 + lane;
      const float ms = s < S ? pm[(size_t)s * G + gg] : NEG_INF;
      float m = ms;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, m, off);
        if (lane >= off) m = fmaxf(m, o);
      }
      const float before = carry[gg];
      m = fmaxf(before, m);
      float prev = __shfl_up_sync(0xffffffffu, m, 1);
      if (lane == 0) prev = before;
      fa[lane][gg] = expf(prev - m);
      fc[lane][gg] = expf(ms - m);
      const float last = __shfl_sync(0xffffffffu, m, 31);
      __syncwarp();
      if (lane == 0) carry[gg] = last;
    }
    __syncthreads();
    if (active) {
      const int cnt = min(COMBINE_CHUNK, S - s0);
      float bl[COMBINE_CHUNK], ba[COMBINE_CHUNK];
#pragma unroll
      for (int u = 0; u < COMBINE_CHUNK; ++u) {  // the loads, all at once
        const size_t s = s0 + (u < cnt ? u : 0);
        bl[u] = pl[s * G];
        ba[u] = pa[s * G * D];
      }
#pragma unroll
      for (int u = 0; u < COMBINE_CHUNK; ++u) {  // the fold, in split order
        if (u < cnt) {
          const float a = fa[u][g], c = fc[u][g];
          l = l * a + bl[u] * c;
          acc = acc * a + ba[u] * c;
        }
      }
    }
  }
  if (active)
    Traits<T>::store(out + (size_t)bh * G * D + idx, acc / fmaxf(l, 1e-30f));
}

// K2: row j of split s is cache slot s * ck + j of the dense slot cache
template <typename T>
struct DenseRows {
  const T* k;       // slot b, head h, the split's first slot
  const T* v;
  const int* map;   // slot b's position map at the split's first slot
  int row_stride;   // Hkv * D
  __device__ __forceinline__ const T* k_row(int j) const { return k + (size_t)j * row_stride; }
  __device__ __forceinline__ const T* v_row(int j) const { return v + (size_t)j * row_stride; }
  __device__ __forceinline__ int kvp(int j) const { return map[j]; }
};

template <typename T, typename C>
__global__ void __launch_bounds__(C::THREADS)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kvp,
                          const int* __restrict__ pos, float* __restrict__ ws_m,
                          float* __restrict__ ws_l, float* __restrict__ ws_acc,
                          int T_len, int Hkv, int G, int D, int kvp_row_stride,
                          int ck, int CHr, int window, int vec) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, S = gridDim.x;
  const int t0 = min(s * ck, T_len);
  const int n = min(ck, T_len - t0);             // the padding past T is
  const int row_stride = Hkv * D;                // masked: it is never read
  const size_t base = ((size_t)b * T_len + t0) * row_stride + (size_t)h * D;
  const DenseRows<T> rows{k + base, v + base,
                          kvp + (size_t)b * kvp_row_stride + t0, row_stride};
  const size_t part = ((size_t)b * Hkv + h) * S + s;
  split_partial<T, C>(smem, rows, q + ((size_t)b * Hkv + h) * G * D, n, CHr,
                      pos[b], window, G, D, vec, ws_m + part * G,
                      ws_l + part * G, ws_acc + part * G * D);
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine_kernel(const float* __restrict__ ws_m,
                            const float* __restrict__ ws_l,
                            const float* __restrict__ ws_acc,
                            T* __restrict__ out, int S, int G, int D) {
  combine<T>(ws_m, ws_l, ws_acc, out, S, G, D);
}

// K3: row j of split s is row j of page page_table[b, s]
template <typename T, typename C>
__global__ void __launch_bounds__(C::THREADS)
paged_flash_decode_split_kernel(const T* __restrict__ q,
                                const T* __restrict__ kp,
                                const T* __restrict__ vp,
                                const int* __restrict__ page_table,
                                const int* __restrict__ pos_map,
                                const int* __restrict__ pos,
                                float* __restrict__ ws_m,
                                float* __restrict__ ws_l,
                                float* __restrict__ ws_acc, int n_pages,
                                int ps, int Hkv, int G, int D, int CHr,
                                int window, int vec) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, npg = gridDim.x;
  int page = page_table[(size_t)b * npg + s];
  page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  const int row_stride = Hkv * D;
  const size_t base = (size_t)page * ps * row_stride + (size_t)h * D;
  const DenseRows<T> rows{kp + base, vp + base,
                          pos_map + ((size_t)b * npg + s) * ps, row_stride};
  const size_t part = ((size_t)b * Hkv + h) * npg + s;
  split_partial<T, C>(smem, rows, q + ((size_t)b * Hkv + h) * G * D, ps, CHr,
                      pos[b], window, G, D, vec, ws_m + part * G,
                      ws_l + part * G, ws_acc + part * G * D);
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_flash_decode_combine_kernel(const float* __restrict__ ws_m,
                                  const float* __restrict__ ws_l,
                                  const float* __restrict__ ws_acc,
                                  T* __restrict__ out, int S, int G, int D) {
  combine<T>(ws_m, ws_l, ws_acc, out, S, G, D);
}

int check_shape(int G, int D) {
  if (D > DMAX || G > GMAX || D <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  return 0;
}

// Bit 0: 16-byte loads of the K / V rows; bit 1: of q. Each needs 16-byte
// rows at 16-byte aligned bases.
template <typename T>
int vector_bits(const void* q, const void* k, const void* v, int D) {
  if ((D * sizeof(T)) % 16 != 0) return 0;
  return ((((uintptr_t)k | (uintptr_t)v) % 16 == 0) ? 1 : 0) |
         ((uintptr_t)q % 16 == 0 ? 2 : 0);
}

dim3 combine_grid(int B, int Hkv, int G, int D) {
  return dim3(B * Hkv, (G * D + COMBINE_THREADS - 1) / COMBINE_THREADS);
}

// Above 48 KB a block's dynamic shared memory needs the opt-in, once per
// kernel instance.
template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)max_smem_bytes());
}

struct DenseSplit {
  const void *q, *k, *v, *kvp, *pos;
  void *ws_m, *ws_l, *ws_acc;
  int B, T_len, Hkv, G, D, kvp_row_stride, ck, num_split, CHr, window, vec;
  cudaStream_t st;
  template <typename T, typename C>
  int run() const {
    static const cudaError_t smem_ok = allow_smem(flash_decode_split_kernel<T, C>);
    if (smem_ok != cudaSuccess) return (int)smem_ok;
    flash_decode_split_kernel<T, C>
        <<<dim3(num_split, Hkv, B), C::THREADS,
           smem_bytes(G, D, CHr, Traits<T>::E, C::GB, C::NW), st>>>(
            (const T*)q, (const T*)k, (const T*)v, (const int*)kvp,
            (const int*)pos, (float*)ws_m, (float*)ws_l, (float*)ws_acc,
            T_len, Hkv, G, D, kvp_row_stride, ck, CHr, window, vec);
    return (int)cudaGetLastError();
  }
};

struct PagedSplit {
  const void *q, *kp, *vp, *page_table, *pos_map, *pos;
  void *ws_m, *ws_l, *ws_acc;
  int B, n_pages, ps, npg, Hkv, G, D, CHr, window, vec;
  cudaStream_t st;
  template <typename T, typename C>
  int run() const {
    static const cudaError_t smem_ok = allow_smem(paged_flash_decode_split_kernel<T, C>);
    if (smem_ok != cudaSuccess) return (int)smem_ok;
    paged_flash_decode_split_kernel<T, C>
        <<<dim3(npg, Hkv, B), C::THREADS,
           smem_bytes(G, D, CHr, Traits<T>::E, C::GB, C::NW), st>>>(
            (const T*)q, (const T*)kp, (const T*)vp, (const int*)page_table,
            (const int*)pos_map, (const int*)pos, (float*)ws_m, (float*)ws_l,
            (float*)ws_acc, n_pages, ps, Hkv, G, D, CHr, window, vec);
    return (int)cudaGetLastError();
  }
};

// The split kernel instance for (G, rows a chunk), so K2 and K3 pick the
// same one for the same split length: Narrow where a chunk fits one batch of
// its warps (K3's 16-row pages), else Wide; GB = 2 where G <= 2 (GB changes
// no sum's order, the warp count does).
template <typename T, typename Split>
int launch_split(const Split& split) {
  const bool narrow = split.CHr <= Narrow<2>::NW * Narrow<2>::R;
  if (split.G <= 2)
    return narrow ? split.template run<T, Narrow<2>>()
                  : split.template run<T, Wide<T, 2>>();
  return narrow ? split.template run<T, Narrow<GB_MAX>>()
                : split.template run<T, Wide<T, GB_MAX>>();
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, const void* kvp,
                 const void* pos, void* out, void* ws_m, void* ws_l,
                 void* ws_acc, int B, int T_len, int Hkv, int G, int D,
                 int kvp_row_stride, int ck, int num_split, int window,
                 cudaStream_t st) {
  const DenseSplit split{q, k, v, kvp, pos, ws_m, ws_l, ws_acc, B, T_len,
                         Hkv, G, D, kvp_row_stride, ck, num_split,
                         chunk_rows(G, ck), window,
                         vector_bits<T>(q, k, v, D), st};
  if (int e = launch_split<T>(split)) return e;
  flash_decode_combine_kernel<T>
      <<<combine_grid(B, Hkv, G, D), COMBINE_THREADS, 0, st>>>(
          (const float*)ws_m, (const float*)ws_l, (const float*)ws_acc,
          (T*)out, num_split, G, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const void* page_table, const void* pos_map, const void* pos,
                 void* out, void* ws_m, void* ws_l, void* ws_acc, int B,
                 int n_pages, int ps, int npg, int Hkv, int G, int D,
                 int window, cudaStream_t st) {
  const PagedSplit split{q, kp, vp, page_table, pos_map, pos, ws_m, ws_l,
                         ws_acc, B, n_pages, ps, npg, Hkv, G, D,
                         chunk_rows(G, ps), window,
                         vector_bits<T>(q, kp, vp, D), st};
  if (int e = launch_split<T>(split)) return e;
  paged_flash_decode_combine_kernel<T>
      <<<combine_grid(B, Hkv, G, D), COMBINE_THREADS, 0, st>>>(
          (const float*)ws_m, (const float*)ws_l, (const float*)ws_acc,
          (T*)out, npg, G, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws_m, ws_l: (B, Hkv, num_split, G) fp32; ws_acc: (B, Hkv, num_split, G, D)
// fp32, written by the split kernel and read by the combine.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* kvp, const void* pos, void* out,
                        void* ws_m, void* ws_l, void* ws_acc, int B,
                        int T_len, int Hkv, int G, int D, int kvp_row_stride,
                        int ck, int num_split, int window, int is_bf16,
                        void* stream) {
  if (int e = check_shape(G, D)) return e;
  if (B <= 0 || Hkv <= 0 || T_len <= 0 || ck <= 0 || num_split <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dense<__nv_bfloat16>(q, k, v, kvp, pos, out, ws_m, ws_l,
                                       ws_acc, B, T_len, Hkv, G, D,
                                       kvp_row_stride, ck, num_split, window,
                                       st);
  return launch_dense<float>(q, k, v, kvp, pos, out, ws_m, ws_l, ws_acc, B,
                             T_len, Hkv, G, D, kvp_row_stride, ck, num_split,
                             window, st);
}

// ws_*: as above with num_split = npg (one split a page)
int paged_flash_decode_launch(const void* q, const void* kp, const void* vp,
                              const void* page_table, const void* pos_map,
                              const void* pos, void* out, void* ws_m,
                              void* ws_l, void* ws_acc, int B, int n_pages,
                              int ps, int npg, int Hkv, int G, int D,
                              int window, int is_bf16, void* stream) {
  if (int e = check_shape(G, D)) return e;
  if (n_pages <= 0 || ps <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hkv <= 0 || npg <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_paged<__nv_bfloat16>(q, kp, vp, page_table, pos_map, pos,
                                       out, ws_m, ws_l, ws_acc, B, n_pages,
                                       ps, npg, Hkv, G, D, window, st);
  return launch_paged<float>(q, kp, vp, page_table, pos_map, pos, out, ws_m,
                             ws_l, ws_acc, B, n_pages, ps, npg, Hkv, G, D,
                             window, st);
}

}  // extern "C"
