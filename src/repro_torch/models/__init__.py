"""Model assembly of the port: primitives, MoE layer, stack, top-level model."""
from repro_torch.models.model import Model

__all__ = ["Model"]
