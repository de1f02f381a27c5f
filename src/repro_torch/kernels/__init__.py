"""Block-sparse kernels: host packs, execution plans, kernel K1."""
from repro_torch.kernels.bsr_matmul import (KernelBSR, PlanSchedule,
                                            pack_bsr, plan_dds)
from repro_torch.kernels.exec_plan import (PlanChoice, RowPackPlan,
                                           build_plan, default_plan_registry,
                                           kernel_pattern_fingerprint,
                                           pack_plan_data, plan_for_pack,
                                           plan_fused_linear,
                                           plan_fused_linear_plain,
                                           plan_kernel_sequence, plan_linear,
                                           plan_linear_pallas, plan_matmul,
                                           plan_matmul_pallas, plan_schedule,
                                           unpack_plan_data)
from repro_torch.kernels.ops import default_plan_backend, plan_dispatch
