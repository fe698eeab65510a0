"""Training harness of the port: TrainState, the (microbatched, guarded)
train step, on one device or one rank of a mesh, the checkpointed host
loop, test perplexity."""
from repro_torch.training.loop import (
    CTRL_FORCE_SKIP,
    CTRL_INJECT_NAN,
    CTRL_LR_SCALE,
    TrainLog,
    TrainState,
    compile_train_step,
    default_controls,
    evaluate_ppl,
    init_train_state,
    make_train_step,
    train_loop,
)

__all__ = [
    "CTRL_FORCE_SKIP",
    "CTRL_INJECT_NAN",
    "CTRL_LR_SCALE",
    "TrainLog",
    "TrainState",
    "compile_train_step",
    "default_controls",
    "evaluate_ppl",
    "init_train_state",
    "make_train_step",
    "train_loop",
]
