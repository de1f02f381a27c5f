"""Model zoo of the port: the BERT encoder and the dense-family LM."""
from repro_torch.models.api import (alloc_slot, decode_step, free_slot,
                                    init_cache, init_model, model_forward,
                                    read_slot, reset_slot, write_slot)
