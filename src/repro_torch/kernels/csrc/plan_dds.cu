// K1: the plan-consuming block-sparse matmul Y = act(X @ W^T + bias) over
// fp32 or bf16 tile values, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/bsr_matmul.py:_plan_dds_kernel
// (launched by _plan_dds_call, reached through plan_dds). The schedule walk,
// the staging, the four instances (stream, fp32, tc, general) and the fused
// epilogue live in plan_dds_common.cuh, shared with K6; this file holds the
// plain value policy's instantiations and the C entry point.
#include "plan_dds_common.cuh"

using plan_dds::Args;
using plan_dds::bf16_t;
using plan_dds::PlainValues;

// Plain C entry point, loaded with ctypes. Every pointer is a device pointer
// (bias may be null); Y has X's dtype. `instance` is the one the wrapper chose
// (0 general, 1 stream, 2 fp32, 3 tc) and `smem` the dynamic shared memory it
// asks for. Returns a CUDA error code: cudaGetLastError() after the launch,
// or the refusal of an instance that cannot take these inputs.
extern "C" int plan_dds_launch(const void* x, const void* w, const void* bias,
                               void* y, const void* seg, const void* col_seq,
                               const void* tile_seq, const void* head_tile,
                               const void* head_col, int M, int K, int N,
                               int n_brows, int bn, int bk, int x_bf16,
                               int w_bf16, int act, int instance, int smem,
                               void* stream) {
  const Args a{x, w, nullptr, static_cast<const float*>(bias), y,
               static_cast<const int*>(seg), static_cast<const int*>(col_seq),
               static_cast<const int*>(tile_seq),
               static_cast<const int*>(head_tile),
               static_cast<const int*>(head_col), M, K, N, n_brows, bn, bk, 1,
               0, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return plan_dds::launch<PlainValues<bf16_t, bf16_t>>(a, instance, smem, s);
  if (x_bf16)
    return plan_dds::launch<PlainValues<bf16_t, float>>(a, instance, smem, s);
  if (w_bf16)
    return plan_dds::launch<PlainValues<float, bf16_t>>(a, instance, smem, s);
  return plan_dds::launch<PlainValues<float, float>>(a, instance, smem, s);
}
