"""Model assembly of the port: primitives, MoE layer, stack, top-level model."""
from repro_torch.models.model import Model, build_model
from repro_torch.models.stack import MeshCtx

__all__ = ["MeshCtx", "Model", "build_model"]
