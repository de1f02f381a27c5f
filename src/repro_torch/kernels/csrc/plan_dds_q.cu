// K6: the plan-consuming block-sparse matmul over quantized tile values,
// Y = act(X @ dequant(Q)^T + bias), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/bsr_matmul.py:_plan_dds_q_kernel
// (launched by _plan_dds_q_call, reached through plan_dds_q). Q is the
// RowPackPlan's (V, P, bn, bk) pack stored as int8 or float8_e4m3fn, with fp32
// scales (V, P) ('block' granularity: one a tile) or (V, 1) ('row': one a
// virtual row, for tiles of fewer than 128 values such as 32x1); tile j's
// scale is scales[tile_seq[j]] or scales[tile_seq[j] / P] -- no second
// schedule. Each tile's partial product is scaled before it joins the
// accumulator, as in the reference. K1's body (plan_dds_common.cuh) runs it
// under the quantized value policy; this file holds the instantiations and
// the C entry point. At decode one byte a value halves K1's weight stream.
#include "plan_dds_common.cuh"

using plan_dds::Args;
using plan_dds::bf16_t;
using plan_dds::fp8_t;
using plan_dds::QuantValues;

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer
// (bias may be null); Y has X's dtype. w_fp8 = 0 reads int8 values, 1 reads
// float8_e4m3fn. `instance` and `smem` as for plan_dds_launch. Returns a CUDA
// error code, so a refused launch is reported to the caller.
extern "C" int plan_dds_q_launch(const void* x, const void* w,
                                 const void* scales, const void* bias, void* y,
                                 const void* seg, const void* col_seq,
                                 const void* tile_seq, const void* head_tile,
                                 const void* head_col, int M, int K, int N,
                                 int n_brows, int bn, int bk, int p_max,
                                 int row_gran, int x_bf16, int w_fp8, int act,
                                 int instance, int smem, void* stream) {
  const Args a{x, w, static_cast<const float*>(scales),
               static_cast<const float*>(bias), y,
               static_cast<const int*>(seg), static_cast<const int*>(col_seq),
               static_cast<const int*>(tile_seq),
               static_cast<const int*>(head_tile),
               static_cast<const int*>(head_col), M, K, N, n_brows, bn, bk,
               p_max, row_gran, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_fp8)
    return plan_dds::launch<QuantValues<bf16_t, fp8_t>>(a, instance, smem, s);
  if (x_bf16)
    return plan_dds::launch<QuantValues<bf16_t, signed char>>(a, instance,
                                                              smem, s);
  if (w_fp8)
    return plan_dds::launch<QuantValues<float, fp8_t>>(a, instance, smem, s);
  return plan_dds::launch<QuantValues<float, signed char>>(a, instance, smem,
                                                           s);
}
