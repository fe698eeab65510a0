"""Config registry of the port: the paper's two minimind MoE models.

`get(name)` accepts the module id or the CLI spelling with dashes;
`reduced_for_smoke(name, **overrides)` applies the reference's `reduced()`.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, RoutingSpec, SSMSpec, reduced

ARCH_IDS = ["minimind_moe_16e", "minimind_moe_64e"]
CLI_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get(name: str) -> ModelConfig:
    key = CLI_ALIASES.get(name, name)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CLI_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def reduced_for_smoke(name: str, **overrides) -> ModelConfig:
    return reduced(get(name), **overrides)


__all__ = [
    "ARCH_IDS",
    "CLI_ALIASES",
    "ModelConfig",
    "RoutingSpec",
    "SSMSpec",
    "get",
    "reduced",
    "reduced_for_smoke",
]
