"""Optimizer: AdamW with clipping and the blockwise group-lasso prox, and
block-sparse gradient compression with error feedback."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, lr_at)
from repro_torch.optim.compression import (CompressionConfig, compress,
                                           compressed_allreduce, compressible,
                                           decompress, init_error_buffers,
                                           make_compressed_sync)
