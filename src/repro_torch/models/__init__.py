"""Model zoo of the port (this slice: the BERT encoder)."""
from repro_torch.models.api import init_model, model_forward
