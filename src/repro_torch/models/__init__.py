"""LM substrate: the dense and MoE transformer (further families in later
slices)."""
from repro_torch.models.transformer import Model

__all__ = ["Model"]
