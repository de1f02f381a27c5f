from repro_torch.checkpoint.store import CheckpointStore
