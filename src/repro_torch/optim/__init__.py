"""AdamW and learning-rate schedules of the port (plain torch)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    from_model_config,
    global_norm,
)
from repro_torch.optim.schedules import constant, cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "constant",
    "cosine_schedule",
    "from_model_config",
    "global_norm",
    "linear_warmup_cosine",
]
