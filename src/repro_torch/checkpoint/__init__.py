"""Single-file checkpoints of tensor trees (``torch.save`` format)."""

from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
