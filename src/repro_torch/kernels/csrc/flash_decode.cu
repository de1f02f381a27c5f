// K2 and K3: split-K flash-decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of kernels/flash_decode.py:
//   K2 flash_decode_kernel        <- _flash_decode_call (body _flash_decode_kernel)
//   K3 paged_flash_decode_kernel  <- _paged_flash_call  (same body, one split a page)
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
// order and carries the online-softmax state (m, l, acc) in VMEM scratch. Here
// one block owns one (slot b, KV head h) with the G query rows of that head and
// walks the same splits in the same order itself, keeping m and l in shared
// memory and acc in registers, and writes the output once. Every split is
// folded by one routine (fold_split), which sees only the split's K/V rows and
// positions: K2 finds its rows by stride, K3 through the page table. So K3 is
// bit-exact against K2 over the gathered dense view when the split boundaries
// match (one split = one page).
//
// One split is folded exactly as the TPU kernel does it, with one update of
// the running max per split: a first pass over the split's rows takes the max
// of the masked scores, a second pass recomputes the scores, forms
// p = exp(s - m_new) (zero on masked lanes, which are never loaded) and adds
// p * v into the fp32 accumulator after scaling it by exp(m_old - m_new). A
// fully masked split (empty ring, unmapped page, inactive slot) leaves the
// state as it is; the final l is clamped at 1e-30, so such a row gives zeros.
//
// Work split inside a block (256 threads, 8 warps): rows are taken in tiles of
// 64; all threads first copy the tile's visible K (or V) rows into shared
// memory as fp32, so many loads are in flight at once. A warp then scores one
// row of the tile at a time, each lane taking every 32nd element of D
// (D <= 256), and reduces the G dot products by butterfly shuffles; for the
// value product thread i owns output column i of all G rows and walks the
// tile's rows in order. q is kept in shared memory as fp32; scores and
// probabilities accumulate in fp32 from fp32 or bf16 caches, and the output
// is written in q's dtype.
//
// What bounds it. The work is a few FLOPs per cache byte, so the limit is
// device memory: per call the K and V rows of the visible positions
// (2 * visible * Hkv * D * bytes), the position maps, q and out. The second
// pass reads the split's K rows again; they are hot in L2 (a split is at most
// a few hundred KB). One block per (slot, head) fills B * Hkv SMs of 132, so
// at small batch the card is mostly idle: splitting the KV axis over blocks
// with a combine pass (flash-decoding) is the later step for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DMAX = 256;             // largest head dim (one output column a thread)
constexpr int GMAX = 16;              // largest query group (Hq / Hkv)
constexpr int DPL = DMAX / 32;        // elements of D per lane when scoring
constexpr int SUB = 64;               // cache rows per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ bool visible(int kvp, int pos, int window) {
  bool ok = kvp >= 0 && kvp <= pos;
  if (window > 0) ok = ok && kvp > pos - window;
  return ok;
}

// Dynamic shared memory: q (G*D), one tile of rows (SUB*D), probabilities
// (G*SUB), all fp32; then the small per-row and per-query arrays.
struct Smem {
  float* q;
  float* tile;
  float* p;
  int* ok;
  float* m;
  float* l;
  float* m_new;
  float* corr;
  float* red;
};

__host__ __device__ inline size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + (size_t)SUB * D + (size_t)G * SUB +
                          4 * GMAX + WARPS * GMAX) +
         sizeof(int) * SUB;
}

__device__ inline Smem carve(float* base, int G, int D) {
  Smem s;
  s.q = base;
  s.tile = s.q + G * D;
  s.p = s.tile + SUB * D;
  s.m = s.p + G * SUB;
  s.l = s.m + GMAX;
  s.m_new = s.l + GMAX;
  s.corr = s.m_new + GMAX;
  s.red = s.corr + GMAX;
  s.ok = (int*)(s.red + WARPS * GMAX);
  return s;
}

// Copy rows [j0, j0 + cnt) of the split into the tile: K rows (use_v false)
// or V rows, only where the row is visible (sh.ok, set before).
template <typename T, typename Rows>
__device__ __forceinline__ void load_tile(const Smem& sh, const Rows& rows,
                                          int j0, int cnt, int D, bool use_v) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < cnt * D; idx += THREADS) {
    const int jj = idx / D, d = idx - jj * D;
    if (sh.ok[jj]) {
      const T* row = use_v ? rows.v_row(j0 + jj) : rows.k_row(j0 + jj);
      sh.tile[idx] = to_f32(row[d]);
    }
  }
}

// G scores of tile row jj (all lanes get them): s[g] = q[g] . k * scale
__device__ __forceinline__ void score_row(const Smem& sh, int jj, int G, int D,
                                          float scale, int lane, float (&s)[GMAX]) {
  float kreg[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    kreg[i] = d < D ? sh.tile[jj * D + d] : 0.f;
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float part = 0.f;
    if (g < G) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) part += sh.q[g * D + d] * kreg[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    s[g] = part * scale;
  }
}

// Visibility of rows [j0, j0 + cnt) into sh.ok.
template <typename Rows>
__device__ __forceinline__ void mark_rows(const Smem& sh, const Rows& rows,
                                          int j0, int cnt, int pos, int window) {
  if (threadIdx.x < cnt) sh.ok[threadIdx.x] = visible(rows.kvp(j0 + threadIdx.x), pos, window);
}

// Fold one split of n cache rows into (m, l, acc); acc[g] is this thread's
// output column threadIdx.x of query row g.
template <typename T, typename Rows>
__device__ void fold_split(const Smem& sh, const Rows& rows, int n, int pos,
                           int window, int G, int D, float scale,
                           float (&acc)[GMAX]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // pass 1: the split's max over visible scores, per query row
  float wmax[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) wmax[g] = NEG_INF;
  for (int j0 = 0; j0 < n; j0 += SUB) {
    const int cnt = min(SUB, n - j0);
    mark_rows(sh, rows, j0, cnt, pos, window);
    __syncthreads();
    load_tile<T>(sh, rows, j0, cnt, D, false);
    __syncthreads();
    for (int jj = warp; jj < cnt; jj += WARPS) {
      if (!sh.ok[jj]) continue;                  // uniform across the warp
      float s[GMAX];
      score_row(sh, jj, G, D, scale, lane, s);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) wmax[g] = fmaxf(wmax[g], s[g]);
    }
    __syncthreads();
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) sh.red[warp * GMAX + g] = wmax[g];
  }
  __syncthreads();
  if (tid < G) {
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sh.red[w * GMAX + tid]);
    const float m_new = fmaxf(sh.m[tid], mx);
    sh.m_new[tid] = m_new;
    sh.corr[tid] = expf(sh.m[tid] - m_new);
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) acc[g] *= sh.corr[g];

  // pass 2: probabilities tile by tile, then the value product
  float lsum = 0.f;   // thread g < G: the split's sum of p for query row g
  for (int j0 = 0; j0 < n; j0 += SUB) {
    const int cnt = min(SUB, n - j0);
    mark_rows(sh, rows, j0, cnt, pos, window);
    __syncthreads();
    load_tile<T>(sh, rows, j0, cnt, D, false);
    __syncthreads();
    for (int jj = warp; jj < cnt; jj += WARPS) {
      const bool ok = sh.ok[jj];
      float s[GMAX];
      if (ok) score_row(sh, jj, G, D, scale, lane, s);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) sh.p[g * SUB + jj] = ok ? expf(s[g] - sh.m_new[g]) : 0.f;
      }
    }
    __syncthreads();
    load_tile<T>(sh, rows, j0, cnt, D, true);    // V rows over the K rows
    __syncthreads();
    if (tid < G)
      for (int jj = 0; jj < cnt; ++jj) lsum += sh.p[tid * SUB + jj];
    if (tid < D) {
      for (int jj = 0; jj < cnt; ++jj) {
        if (!sh.ok[jj]) continue;                // uniform across the block
        const float vv = sh.tile[jj * D + tid];
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g] += sh.p[g * SUB + jj] * vv;
      }
    }
    __syncthreads();
  }
  if (tid < G) {
    sh.l[tid] = sh.l[tid] * sh.corr[tid] + lsum;
    sh.m[tid] = sh.m_new[tid];
  }
  __syncthreads();
}

template <typename T>
__device__ void load_q(const Smem& sh, const T* __restrict__ q, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += THREADS) sh.q[i] = to_f32(q[i]);
  if (threadIdx.x < G) {
    sh.m[threadIdx.x] = NEG_INF;
    sh.l[threadIdx.x] = 0.f;
  }
  __syncthreads();
}

template <typename T>
__device__ void write_out(const Smem& sh, T* __restrict__ out, int G, int D,
                          const float (&acc)[GMAX]) {
  if (threadIdx.x >= D) return;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) store(&out[g * D + threadIdx.x], acc[g] / fmaxf(sh.l[g], 1e-30f));
}

// K2: row j of a split is cache slot t0 + j of the dense slot cache
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kvp,
                    const int* __restrict__ pos, T* __restrict__ out, int T_len,
                    int Hkv, int G, int D, int kvp_row_stride, int ck,
                    int num_split, int window) {
  extern __shared__ float smem[];
  const Smem sh = carve(smem, G, D);
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const size_t qoff = ((size_t)b * Hkv + h) * G * D;
  load_q(sh, q + qoff, G, D);
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  const float scale = rsqrtf((float)D);
  const int p = pos[b];
  const int row_stride = Hkv * D;
  const size_t base = ((size_t)b * T_len * Hkv + h) * D;
  for (int s = 0; s < num_split; ++s) {
    const int t0 = s * ck;
    const int n = min(ck, T_len - t0);           // the last split's padding is
    if (n <= 0) break;                           // masked: it is never read
    const DenseRows<T> rows{k + base + (size_t)t0 * row_stride,
                            v + base + (size_t)t0 * row_stride,
                            kvp + (size_t)b * kvp_row_stride + t0, row_stride};
    fold_split<T>(sh, rows, n, p, window, G, D, scale, acc);
  }
  write_out(sh, out + qoff, G, D, acc);
}

// K3: row j of split s is row j of page page_table[b, s]
template <typename T>
struct PagedRows {
  const T* k;       // the page's first row, head h
  const T* v;
  const int* map;   // pos_map[b, s * ps]
  int row_stride;
  __device__ __forceinline__ const T* k_row(int j) const { return k + (size_t)j * row_stride; }
  __device__ __forceinline__ const T* v_row(int j) const { return v + (size_t)j * row_stride; }
  __device__ __forceinline__ int kvp(int j) const { return map[j]; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int* __restrict__ page_table,
                          const int* __restrict__ pos_map,
                          const int* __restrict__ pos, T* __restrict__ out,
                          int n_pages, int ps, int npg, int Hkv, int G, int D,
                          int window) {
  extern __shared__ float smem[];
  const Smem sh = carve(smem, G, D);
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const size_t qoff = ((size_t)b * Hkv + h) * G * D;
  load_q(sh, q + qoff, G, D);
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;

  const float scale = rsqrtf((float)D);
  const int p = pos[b];
  const int row_stride = Hkv * D;
  for (int s = 0; s < npg; ++s) {
    int page = page_table[(size_t)b * npg + s];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    const size_t base = ((size_t)page * ps * Hkv + h) * D;
    const PagedRows<T> rows{kp + base, vp + base,
                            pos_map + (size_t)b * npg * ps + (size_t)s * ps,
                            row_stride};
    fold_split<T>(sh, rows, ps, p, window, G, D, scale, acc);
  }
  write_out(sh, out + qoff, G, D, acc);
}

// Above 48 KB a block's dynamic shared memory needs the opt-in, once per
// kernel (every instantiation has its own signature, so its own static).
template <typename K>
cudaError_t allow_smem(K kernel) {
  static const cudaError_t once = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(GMAX, DMAX));
  return once;
}

int check_shape(int G, int D) {
  if (D > DMAX || G > GMAX || D <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* kvp, const void* pos, void* out, int B,
                        int T_len, int Hkv, int G, int D, int kvp_row_stride,
                        int ck, int num_split, int window, int is_bf16,
                        void* stream) {
  if (int e = check_shape(G, D)) return e;
  if (B <= 0 || Hkv <= 0 || T_len <= 0 || ck <= 0) return 0;
  const size_t bytes = smem_bytes(G, D);
  const dim3 grid(B * Hkv), block(THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16) {
    auto kern = flash_decode_kernel<__nv_bfloat16>;
    if ((e = allow_smem(kern)) != cudaSuccess) return (int)e;
    kern<<<grid, block, bytes, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)kvp, (const int*)pos,
        (__nv_bfloat16*)out, T_len, Hkv, G, D, kvp_row_stride, ck, num_split,
        window);
  } else {
    auto kern = flash_decode_kernel<float>;
    if ((e = allow_smem(kern)) != cudaSuccess) return (int)e;
    kern<<<grid, block, bytes, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)kvp,
        (const int*)pos, (float*)out, T_len, Hkv, G, D, kvp_row_stride, ck,
        num_split, window);
  }
  return (int)cudaGetLastError();
}

int paged_flash_decode_launch(const void* q, const void* kp, const void* vp,
                              const void* page_table, const void* pos_map,
                              const void* pos, void* out, int B, int n_pages,
                              int ps, int npg, int Hkv, int G, int D,
                              int window, int is_bf16, void* stream) {
  if (int e = check_shape(G, D)) return e;
  if (n_pages <= 0 || ps <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hkv <= 0 || npg <= 0) return 0;
  const size_t bytes = smem_bytes(G, D);
  const dim3 grid(B * Hkv), block(THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16) {
    auto kern = paged_flash_decode_kernel<__nv_bfloat16>;
    if ((e = allow_smem(kern)) != cudaSuccess) return (int)e;
    kern<<<grid, block, bytes, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
        (const __nv_bfloat16*)vp, (const int*)page_table, (const int*)pos_map,
        (const int*)pos, (__nv_bfloat16*)out, n_pages, ps, npg, Hkv, G, D,
        window);
  } else {
    auto kern = paged_flash_decode_kernel<float>;
    if ((e = allow_smem(kern)) != cudaSuccess) return (int)e;
    kern<<<grid, block, bytes, st>>>(
        (const float*)q, (const float*)kp, (const float*)vp,
        (const int*)page_table, (const int*)pos_map, (const int*)pos,
        (float*)out, n_pages, ps, npg, Hkv, G, D, window);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
