from repro_torch.ckpt.checkpoint import CheckpointConfig, Checkpointer

__all__ = ["CheckpointConfig", "Checkpointer"]
