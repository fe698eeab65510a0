"""PyTorch/CUDA port of the BIP-balanced MoE system (reference: `repro`).

The port imports torch and numpy, never jax and nothing of `repro`. Entry
points (`models.Model`, `serving.ContinuousBatchingEngine`, `launch.serve`)
run on the GPU unless the caller passes device="cpu".
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    there is no GPU (pass device='cpu' to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
