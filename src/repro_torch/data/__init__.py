"""Data: the deterministic token pipeline."""
from repro_torch.data.pipeline import DataConfig, DataPipeline
