"""Kernels: host packs, execution plans, K1 (block-sparse matmul), K4 / K5
(its backward: DDS and SDDMM), K6 (K1 over quantized values), K7 (the
masked dense-layout matmul) and K2 / K3 (split-K decode attention)."""
from repro_torch.kernels.bsr_matmul import (PLAN_INSTANCES, KernelBSR,
                                            PlanSchedule, TileSequence, dds,
                                            dds_t, masked_matmul,
                                            masked_matmul_plain, pack_bsr,
                                            plan_dds, plan_dds_q,
                                            plan_dds_q_plain, plan_dds_t,
                                            plan_instance, plan_sddmm, sddmm)
from repro_torch.kernels.exec_plan import (PlanChoice, QuantPlan,
                                           RowPackPlan, build_plan,
                                           default_plan_registry,
                                           dequantize_plan_values,
                                           kernel_pattern_fingerprint,
                                           pack_plan_data, plan_for_pack,
                                           plan_fused_linear,
                                           plan_fused_linear_plain,
                                           plan_kernel_sequence, plan_linear,
                                           plan_linear_pallas, plan_matmul,
                                           plan_matmul_pallas,
                                           plan_q_linear,
                                           plan_q_linear_pallas,
                                           plan_q_matmul,
                                           plan_q_matmul_pallas, plan_schedule,
                                           plan_t_schedule, plan_t_sequence,
                                           quant_granularity,
                                           quantize_for_plan,
                                           quantize_plan_values,
                                           unpack_plan_data)
from repro_torch.kernels.flash_decode import (decode_kernel_override,
                                              default_kv_split, flash_decode,
                                              flash_decode_plain,
                                              paged_flash_decode,
                                              paged_flash_decode_plain,
                                              resolved_decode_kernel)
from repro_torch.kernels.ops import (bsr_linear, default_backend,
                                     default_plan_backend, plan_dispatch,
                                     plan_q_dispatch)
