"""Training harness of the port (single device): TrainState, the train step,
the host loop and test perplexity (port of src/repro/training/loop.py).

The step threads three trees: params, the AdamW state and the per-MoE-layer
router states (the BIP dual q / Loss-Free bias), exactly as the reference:
loss and gradients of `Model.loss_fn`, then AdamW with global-norm clipping,
and the router states the forward returned carry to the next step. Master
params and Adam moments stay fp32; the model casts each weight to the
compute dtype at its use site, so gradients arrive in fp32.

Differences from the reference, by design of an eager port:
  * the AdamW update is in place (params and moments are updated under
    torch.no_grad(); there is no donation to ask for);
  * microbatching (gradient accumulation) and the guarded step are not
    ported yet: `make_train_step` raises for them (ROADMAP.md, queue 1);
  * `train_loop` has no checkpoints, guard ladder or telemetry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.metrics import BalanceTracker
from repro_torch.models.model import Model
from repro_torch.optim import adamw as _adamw
from repro_torch.optim.schedules import linear_warmup_cosine

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1: training slice deferrals)"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    router_states: Any


def init_train_state(model: Model, seed: int, opt_cfg: _adamw.AdamWConfig) -> TrainState:
    params = model.init(seed)
    return TrainState(
        params=params,
        opt_state=_adamw.adamw_init(params, opt_cfg),
        router_states=model.init_router_states(),
    )


def make_train_step(
    model: Model,
    opt_cfg: _adamw.AdamWConfig,
    lr_fn: Callable[[int], float],
    *,
    microbatches: int = 1,
    guarded: bool = False,
):
    """Returns train_step(state, batch) -> (state, metrics).

    The step updates `state` in place and returns it; metrics stay on the
    device ('loss', 'ce_loss', 'aux_loss', 'perplexity', 'grad_norm', 'lr'
    and the stack's '<key>_per_layer' columns), so the step itself never
    waits for the device.
    """
    if microbatches > 1:
        raise NotImplementedError(f"microbatches > 1 (gradient accumulation) {_NOT_PORTED}")
    if guarded:
        raise NotImplementedError(f"the guarded train step {_NOT_PORTED}")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = _adamw.tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss, (new_router, mets) = model.loss_fn(state.params, batch, state.router_states)
        grads = torch.autograd.grad(loss, leaves)
        lr = lr_fn(state.opt_state["step"])
        _, _, info = _adamw.adamw_update(list(grads), state.opt_state, state.params, lr, opt_cfg)
        state.router_states = new_router
        mets = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in mets.items()}
        mets["loss"] = loss.detach()
        mets.update(info)
        return state, mets

    return train_step


class TrainLog:
    """Host-side record of one run, with the paper's balance metrics: per
    step CE loss, perplexity, wall time and per-layer MaxVio, accumulated
    into per-layer and model-level AvgMaxVio / SupMaxVio."""

    def __init__(self) -> None:
        self.losses: List[float] = []
        self.perplexities: List[float] = []
        self.step_times: List[float] = []
        self.max_vio_steps: List[np.ndarray] = []
        self.per_layer: List[BalanceTracker] = []
        self.model_tracker = BalanceTracker()

    def __len__(self) -> int:
        return len(self.losses)

    def record(self, mets: Dict[str, Any], dt: float) -> None:
        self.losses.append(float(mets["ce_loss"]))
        self.perplexities.append(float(mets["perplexity"]))
        self.step_times.append(dt)
        vios = mets.get("max_vio_per_layer")
        vios = np.zeros(0) if vios is None else np.asarray(torch.as_tensor(vios).cpu(), np.float64)
        if vios.size:
            self.max_vio_steps.append(vios)
            if not self.per_layer:
                self.per_layer = [BalanceTracker() for _ in range(vios.size)]
            for t, v in zip(self.per_layer, vios):
                t.add(float(v))
            # model-level MaxVio for the batch = max over layers (conservative)
            self.model_tracker.add(float(vios.max()))

    def summary(self) -> Dict[str, Any]:
        times = self.step_times
        out = {
            "final_loss": self.losses[-1] if self.losses else None,
            "final_ppl": self.perplexities[-1] if self.perplexities else None,
            "mean_step_time": None,
            "step_time_p50": None,
            "step_time_p99": None,
            **self.model_tracker.summary(),
        }
        if len(times) > 2:
            # skip the first two steps (kernel builds + warm caches) so the
            # quantiles describe steady-state throughput
            steady = np.asarray(times[2:], dtype=np.float64)
            out["mean_step_time"] = float(steady.mean())
            out["step_time_p50"] = float(np.percentile(steady, 50))
            out["step_time_p99"] = float(np.percentile(steady, 99))
        if self.per_layer:
            out["AvgMaxVio_per_layer"] = [t.avg_max_vio for t in self.per_layer]
        return out


def train_loop(
    model: Model,
    batches: Iterable[Dict[str, torch.Tensor]],
    *,
    seed: int = 0,
    lr: float = 3e-4,
    warmup_steps: int = 20,
    total_steps: int = 200,
    log_every: int = 0,
    state: Optional[TrainState] = None,
) -> Tuple[TrainState, TrainLog]:
    """Host loop on one device: the reference's schedule wiring (AdamW
    from the model config, linear warmup then cosine to 10% of `lr`),
    stopping at `total_steps` even for an endless stream. Each step's wall
    time is taken around work that ends in reading the loss, so it covers
    the device work of the step."""
    opt_cfg = _adamw.from_model_config(model.cfg)
    if state is None:
        state = init_train_state(model, seed, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, linear_warmup_cosine(lr, warmup_steps, total_steps))
    log = TrainLog()
    it = iter(batches)
    i = -1
    while not total_steps or i + 1 < total_steps:  # never pull a batch it won't train on
        batch = next(it, None)
        if batch is None:
            break
        i += 1
        t0 = time.perf_counter()
        state, mets = step_fn(state, batch)
        float(mets["loss"])  # wait for the step's device work
        dt = time.perf_counter() - t0
        log.record(mets, dt)
        if log_every and i % log_every == 0:
            vio = f" maxvio {log.max_vio_steps[-1].max():.3f}" if log.max_vio_steps else ""
            print(f"step {i:5d} loss {log.losses[-1]:.4f} ppl {log.perplexities[-1]:.2f}{vio}")
    return state, log


@torch.no_grad()
def evaluate_ppl(model: Model, state: TrainState, batches) -> float:
    """Test perplexity with the routing states frozen (each batch routes from
    the trained states; their updates are dropped). Per-batch CE means are
    weighted by each batch's count of valid labels."""
    ces, ns = [], []
    for batch in batches:
        _, (_, mets) = model.loss_fn(state.params, batch, state.router_states)
        ces.append(float(mets["ce_loss"]))
        ns.append(int((batch["labels"] >= 0).sum()))
    return float(np.exp(np.average(ces, weights=ns)))
