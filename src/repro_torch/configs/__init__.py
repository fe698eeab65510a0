"""Config registry of the port: the reference's ten assigned architectures
and the paper's two minimind MoE models, with the reference's ids and CLI
spellings (src/repro/configs/__init__.py).

`get(name)` accepts the module id or the CLI spelling with dashes, and also
resolves the port's own configurations (PORT_IDS, which the reference has
no counterpart of and which ARCH_IDS, CLI_ALIASES and `all_configs()`
leave out);
`reduced_for_smoke(name, **overrides)` applies the reference's `reduced()`;
`all_configs()` maps every id to its config.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, RoutingSpec, SSMSpec, reduced

ARCH_IDS = [
    "zamba2_7b",
    "paligemma_3b",
    "llama4_scout_17b_a16e",
    "deepseek_coder_33b",
    "phi4_mini_3_8b",
    "mamba2_130m",
    "seamless_m4t_large_v2",
    "gemma2_27b",
    "arctic_480b",
    "stablelm_1_6b",
    # the paper's own models (minimind MoE)
    "minimind_moe_16e",
    "minimind_moe_64e",
]

# external ids (with dashes) as used on the CLI --arch flag
CLI_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
CLI_ALIASES.update({"phi4-mini-3.8b": "phi4_mini_3_8b", "stablelm-1.6b": "stablelm_1_6b"})

# the port's own configurations, by module id and by their published name
PORT_IDS = ["granite_4_0_h_small"]
_PORT_ALIASES = {"granite-4.0-h-small": "granite_4_0_h_small"}


def get(name: str) -> ModelConfig:
    key = CLI_ALIASES.get(name, _PORT_ALIASES.get(name, name))
    if key not in ARCH_IDS and key not in PORT_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CLI_ALIASES) + sorted(_PORT_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def reduced_for_smoke(name: str, **overrides) -> ModelConfig:
    return reduced(get(name), **overrides)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS",
    "CLI_ALIASES",
    "ModelConfig",
    "PORT_IDS",
    "RoutingSpec",
    "SSMSpec",
    "all_configs",
    "get",
    "reduced",
    "reduced_for_smoke",
]
