"""Training harness of the port: TrainState, the train step, the host loop."""
from repro_torch.training.loop import (
    TrainLog,
    TrainState,
    evaluate_ppl,
    init_train_state,
    make_train_step,
    train_loop,
)

__all__ = [
    "TrainLog",
    "TrainState",
    "evaluate_ppl",
    "init_train_state",
    "make_train_step",
    "train_loop",
]
