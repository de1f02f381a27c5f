"""Optimizer: AdamW with clipping and the blockwise group-lasso prox."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, lr_at)
