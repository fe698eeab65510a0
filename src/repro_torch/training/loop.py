"""Training harness of the port (single device): TrainState, the train step
(microbatched and guarded), the checkpointed host loop and test perplexity
(port of src/repro/training/loop.py).

The step threads three trees: params, the AdamW state and the per-MoE-layer
router states (the BIP dual q / Loss-Free bias), exactly as the reference:
loss and gradients of `Model.loss_fn`, then AdamW with global-norm clipping,
and the router states the forward returned carry to the next step. Master
params and Adam moments stay fp32; the model casts each weight to the
compute dtype at its use site, so gradients arrive in fp32.

* **Gradient accumulation** - `microbatches=k` splits the batch's rows
  into k consecutive microbatches and runs forward/backward on each in
  turn; the router states thread through them sequentially (the BIP dual
  q updates between microbatches), gradients sum in the param dtype and
  are divided by k, and the metrics reduce as the reference's
  `_reduce_micro_mets`.
* **The guarded step** - `guarded=True` makes the step
  train_step(state, batch, controls) with the reference's (3,) controls
  (CTRL_*): ok = isfinite(loss) & isfinite(grad_norm) & ~force_skip is
  formed on the device before any write, every write (params, both
  moments, the router states) is torch.where(ok, new, old), and the host
  advances the optimizer's step only after reading ok at the end of the
  step (the loop reads the loss there anyway). A skipped step leaves the
  state bit-identical.
* **Checkpoints** - `train_loop(ckpt_dir=, ckpt_every=, resume=,
  async_ckpt=)` saves the full TrainState through `checkpoint.store` in the
  reference's npz layout, with the data stream's cursor beside it, and
  resumes bit-exactly on the CPU.
* **Telemetry** - `make_train_step(telemetry=)` / `train_loop(telemetry=)`
  write each step's metrics into a `telemetry.TrainTelemetry` ring on the
  device after the step and drain it asynchronously to a sink; the state
  trajectory is bitwise the one without it. The step's phases carry the
  reference's profiler span names ('train/fwd_bwd', 'train/apply').

* **A mesh** - `compile_train_step(..., mesh=)` / `train_loop(mesh=)` run
  the step as one rank of an SPMD program over a torch DeviceMesh (the
  model from `build_model(cfg, make_mesh_ctx(mesh))`): every TrainState
  leaf at rest is this rank's block as `distributed.train_state_specs`
  lays it out (params and both moments; router states and the step
  replicated), the batch is the rank's rows of the global batch
  (`distributed.batch_layout`; the step tells the model's MeshCtx whether
  the batch split), the gradients arrive as blocks (the model
  gathers leaves at use), AdamW updates the blocks, and the clipping norm
  is psum'd over the ranks that hold distinct blocks of each leaf.
  Microbatch i of a mesh step is rows [i*B/k, (i+1)*B/k) of the global
  batch, as in the reference, and each rank takes its block of each
  (`shard_batch`). Checkpoints of a mesh run are the same files, whole:
  saves gather onto rank 0, restores cut every rank's blocks from the
  file (checkpoint.store), and the guard's rollback and the SIGTERM save
  run on every rank at the same step.

Differences from the reference, by design of an eager port: the AdamW
update is in place (params and moments are updated under torch.no_grad();
there is no donation to ask for), and the step's controls are host values.
"""
from __future__ import annotations

import copy
import dataclasses
import re
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.convert import decay_mask
from repro_torch.core.metrics import BalanceTracker
from repro_torch.data.prefetch import batch_to_torch
from repro_torch.distributed import batch_layout, collectives, shard_tree, train_state_specs
from repro_torch.models.model import Model
from repro_torch.optim import adamw as _adamw
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.robustness.guards import ROLLBACK, GuardConfig, TrainGuard, TrainingDiverged
from repro_torch.telemetry.metrics import TrainTelemetry
from repro_torch.telemetry.trace import named_span

# control-vector layout of the guarded train step (the reference's): a (3,)
# float vector of per-step scalars the host sets
CTRL_INJECT_NAN = 0  # > 0: fault injection - scale the loss (hence grads) by NaN
CTRL_FORCE_SKIP = 1  # > 0: keep the pre-step state (planned skip / replay)
CTRL_LR_SCALE = 2    # multiplier on the scheduled LR (guard's reduce-LR ladder)


def default_controls() -> np.ndarray:
    """The guarded step's controls when the host asks for nothing."""
    return np.array([0.0, 0.0, 1.0], np.float32)


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


_ENCODER_CROSS = re.compile(r"encoder\.layers\[\d+\]\.(cross|cross_norm)\.")


def unused_leaves(cfg, params) -> Set[str]:
    """Paths of the leaves the loss never reaches: an encdec model's encoder
    layers carry cross-attention leaves (`encoder.layers[*].cross.*`,
    `encoder.layers[*].cross_norm.*`) that nothing uses, as in the
    reference's layout; every other model has none."""
    if not cfg.n_enc_layers:
        return set()
    return {path for path, _ in _adamw.tree_paths(params) if _ENCODER_CROSS.match(path)}


def _state_specs(model: Model, state: "TrainState") -> "TrainState":
    """The spec tree of a TrainState on the model's mesh (params and both
    moments as the model's MeshCtx.param_specs, the router states and the
    step replicated), from the specs alone: `state` may hold blocks."""
    from repro_torch.distributed import router_state_specs

    pspecs = model.mesh_ctx.param_specs
    return TrainState(params=pspecs, opt_state={"step": (), "mu": pspecs, "nu": pspecs},
                      router_states=router_state_specs(state.router_states))


def micro_layout(cfg, mesh, batch: Dict[str, Any], microbatches: int = 1) -> Dict[str, tuple]:
    """distributed.batch_layout of one microbatch of `batch` (B / k rows):
    split over the data axes when those rows divide, else replicated."""
    return batch_layout(cfg, mesh, _split_micro(batch, microbatches)[0])


def shard_batch(batch: Dict[str, torch.Tensor], b_specs, mesh, microbatches: int = 1):
    """This rank's share of a global batch for a step of `microbatches`
    microbatches laid out by `b_specs` (`micro_layout`): its block of each
    microbatch (rows [i*B/k, (i+1)*B/k) of the global batch, the
    reference's `_split_micro`), concatenated in order, so that the step's
    own split of the rank's rows into k gives microbatch i's block."""
    if microbatches == 1:
        return shard_tree(batch, b_specs, mesh)
    parts = [shard_tree(mb, b_specs, mesh) for mb in _split_micro(batch, microbatches)]
    return {k: torch.cat([p[k] for p in parts]) for k in batch}


def _split_micro(batch: Dict[str, torch.Tensor], k: int) -> List[Dict[str, torch.Tensor]]:
    """Rows [i*B/k, (i+1)*B/k) of every batch entry, i < k (the reference's
    reshape to (k, B/k, ...))."""
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"a batch of {b} rows does not split into {k} microbatches")
    n = b // k
    return [{key: v[i * n:(i + 1) * n] for key, v in batch.items()} for i in range(k)]


def _reduce_micro_mets(mets: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-microbatch metrics -> per-step values, as the reference: MaxVio
    by max (the worst microbatch), dispatch counts by sum (integer), the
    dual |q| and forecaster error by the last microbatch (the carried state
    after the step), scalars by mean; perplexity recomputed from the mean
    CE, so it stays exp(mean nll)."""
    out = {}
    for name in mets[0]:
        v = torch.stack([m[name] for m in mets])
        if name == "max_vio_per_layer":
            out[name] = v.max(dim=0).values
        elif name == "load_per_layer":
            out[name] = v.sum(dim=0)
        elif name in ("q_abs_max_per_layer", "forecast_err_per_layer"):
            out[name] = v[-1]
        elif name != "perplexity":
            out[name] = (v if v.is_floating_point() else v.float()).mean(dim=0)
    if "ce_loss" in out:
        out["perplexity"] = torch.exp(out["ce_loss"])
    return out


def _select(ok: torch.Tensor, new, old):
    """torch.where(ok, new, old) over two same-structured trees."""
    if isinstance(new, dict):
        return {k: _select(ok, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return [_select(ok, a, b) for a, b in zip(new, old)]
    return None if new is None else torch.where(ok, new, old)


def _spec_leaves(params, specs) -> List[tuple]:
    """The specs of `params`' leaves in the order of tree_leaves(params)
    (a spec is a tuple, so the walk follows the params tree)."""
    if isinstance(params, dict):
        return [sp for k in sorted(params) for sp in _spec_leaves(params[k], specs[k])]
    if isinstance(params, (list, tuple)):
        return [sp for v, s in zip(params, specs) for sp in _spec_leaves(v, s)]
    return [] if params is None else [specs]


def sharded_grad_norm(grads: List[torch.Tensor], specs: List[tuple], mesh) -> torch.Tensor:
    """The global gradient norm from this rank's blocks: each leaf's squared
    norm is summed over the ranks of the axes its spec splits it over, so a
    block held by several ranks (replicated over the others) counts once.
    One psum per distinct set of axes."""
    order = list(collectives.mesh_shape(mesh))
    by_axes: Dict[tuple, torch.Tensor] = {}
    for g, spec in zip(grads, specs):
        axes = tuple(sorted({a for e in spec for a in collectives.spec_axes(e)}, key=order.index))
        sq = torch.sum(torch.square(g.float()))
        by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
    with collectives.axis_env(mesh):
        total = sum(collectives.psum(v, axes) for axes, v in by_axes.items())
    return torch.sqrt(total)


def make_train_step(
    model: Model,
    opt_cfg: _adamw.AdamWConfig,
    lr_fn: Callable[[int], float],
    *,
    microbatches: int = 1,
    guarded: bool = False,
    telemetry: Optional[TrainTelemetry] = None,
):
    """Returns train_step(state, batch) -> (state, metrics), or with
    `guarded=True` train_step(state, batch, controls) (see CTRL_*).

    `telemetry` (a TrainTelemetry) instruments the step as the reference's
    compiled step: it takes two more arguments, the metric ring and the
    step index, and returns (state, metrics, ring). The ring's layout is
    built from the first step's metrics (a None ring then means the
    telemetry's own); after each step its metrics are written into the
    ring (`MetricStream.accumulate`, no host sync).

    The step updates `state` in place and returns it; metrics stay on the
    device ('loss', 'ce_loss', 'aux_loss', 'perplexity', 'grad_norm', 'lr',
    the stack's '<key>_per_layer' columns and, guarded, 'step_ok'). The
    unguarded step never waits for the device; the guarded one reads
    'step_ok' once, after every launch of the step is issued. With
    microbatches=k the batch's rows must divide by k (ValueError).

    The leaves the loss may leave without a gradient are exactly those of
    `unused_leaves` (an encdec model's encoder cross leaves); they get zero
    gradients, so AdamW decays them as the reference's does. Any other
    leaf the loss does not reach, or an allowed one it does, raises
    RuntimeError naming its path.

    A model on a mesh (`build_model(cfg, mesh_ctx)`) makes this one rank's
    step: `state` holds its blocks, `batch` its rows of the global batch
    (or the whole batch on every rank: MeshCtx.tokens_sharded False, see
    compile_train_step), and the clipping norm is `sharded_grad_norm`,
    taken once, of the averaged gradients. With microbatches the rank's
    rows are its blocks of the k microbatches in order (`shard_batch`)."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    mesh = model.mesh_ctx.mesh

    def fwd_bwd(params, leaves, batch, router, inject_nan):
        with named_span("train/fwd_bwd"):
            loss, (router, mets) = model.loss_fn(params, batch, router)
            if inject_nan:
                # fault seam (robustness/faults.NanGrad): grads = NaN * dL
                loss = loss * float("nan")
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            unused = {path for path, g in zip(decay, grads) if g is None}  # decay: every path, in order
            if unused != no_grad_ok:
                raise RuntimeError(
                    "the loss does not reach exactly the leaves allowed no gradient: unused "
                    f"{sorted(unused - no_grad_ok)}, allowed but used {sorted(no_grad_ok - unused)}")
            # the encoder's cross leaves: zero gradients, as jax.grad gives them
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        mets = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in mets.items()}
        mets["loss"] = loss.detach()
        return grads, router, mets

    decay: Dict[str, bool] = {}  # AdamW's weight-decay mask, built at the first step
    no_grad_ok: Set[str] = set()  # the leaves the loss never reaches, built with `decay`
    leaf_specs: List[tuple] = []  # on a mesh: each leaf's spec, in tree_leaves order

    def run(state: TrainState, batch, controls):
        if not decay:
            decay.update(decay_mask(state.params))
            no_grad_ok.update(unused_leaves(model.cfg, state.params))
            if mesh is not None:
                leaf_specs.extend(_spec_leaves(state.params, model.mesh_ctx.param_specs))
        inject, force_skip, lr_scale = (False, False, 1.0) if controls is None else (
            float(controls[CTRL_INJECT_NAN]) > 0,
            float(controls[CTRL_FORCE_SKIP]) > 0,
            float(controls[CTRL_LR_SCALE]),
        )
        leaves = _adamw.tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            grads, new_router, mets = fwd_bwd(state.params, leaves, batch, state.router_states, inject)
        else:
            router, acc, per_mb = state.router_states, None, []
            for mb in _split_micro(batch, microbatches):
                grads, router, mets = fwd_bwd(state.params, leaves, mb, router, inject)
                if acc is None:  # accumulate in the param dtype, as the reference
                    acc = [g.to(p.dtype) for g, p in zip(grads, leaves)]
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g.to(a.dtype))
                per_mb.append(mets)
            grads = [a / microbatches for a in acc]
            new_router, mets = router, _reduce_micro_mets(per_mb)
        lr = lr_fn(state.opt_state["step"])
        if controls is not None:
            lr = lr * lr_scale
        guard = None
        if controls is not None:
            guard = torch.isfinite(mets["loss"]) & (not force_skip)
        gnorm = None if mesh is None else sharded_grad_norm(list(grads), leaf_specs, mesh)
        with named_span("train/apply"):
            _, _, info = _adamw.adamw_update(list(grads), state.opt_state, state.params, lr, opt_cfg,
                                             guard=guard, decay=decay, grad_norm=gnorm)
        mets.update(info)
        if controls is None:
            state.router_states = new_router
            return state, mets
        ok = info["step_ok"]
        with torch.no_grad():
            state.router_states = _select(ok, new_router, state.router_states)
        if bool(ok):  # the step's one host read, after all of its launches
            state.opt_state["step"] += 1
        return state, mets

    if not guarded:
        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            return run(state, batch, None)
    else:
        def step(state: TrainState, batch: Dict[str, torch.Tensor], controls):
            return run(state, batch, controls)
    if telemetry is None:
        return step

    def instrumented_step(*args):
        *inner, buf, step_idx = args
        new_state, mets = step(*inner)
        telemetry.ensure_built(mets)
        buf = telemetry.stream.accumulate(telemetry.buf if buf is None else buf, mets, step_idx)
        return new_state, mets, buf

    return instrumented_step


def compile_train_step(
    model: Model,
    opt_cfg: _adamw.AdamWConfig,
    lr_fn: Callable[[int], float],
    state: TrainState,
    batch: Dict[str, Any],
    *,
    mesh=None,
    microbatches: int = 1,
    st_specs=None,
    b_specs=None,
    guarded: bool = False,
    telemetry: Optional[TrainTelemetry] = None,
):
    """The train step for `state` and batches shaped like `batch` (the
    reference's jit with explicit shardings; here the step is built, not
    compiled). Without a mesh it is `make_train_step`. With one the model
    must be laid out on it (`build_model(cfg, make_mesh_ctx(mesh))`) and
    the step expects the rank's blocks of a state laid out as
    `distributed.train_state_specs` gives (`st_specs`, where the caller
    has them, is checked against the model's layout: ValueError) and the
    rank's rows of a batch laid out by `b_specs` (default: `micro_layout`
    of `batch`, each microbatch's layout), as `shard_batch` cuts them."""
    if mesh is not None:
        if model.mesh_ctx.mesh is not mesh:
            raise ValueError("compile_train_step(mesh=): build the model with "
                             "build_model(cfg, make_mesh_ctx(mesh)) on the same mesh")
        if st_specs is not None and st_specs.params != model.mesh_ctx.param_specs:
            raise ValueError("compile_train_step(mesh=): st_specs lay the params out otherwise than "
                             "the model's MeshCtx.param_specs")
        if b_specs is None:
            b_specs = micro_layout(model.cfg, mesh, batch, microbatches)
        model = _on_batch_layout(model, b_specs)
    return make_train_step(model, opt_cfg, lr_fn, microbatches=microbatches, guarded=guarded,
                           telemetry=telemetry)


def _on_batch_layout(model: Model, b_specs) -> Model:
    """`model` with its MeshCtx saying whether a batch laid out by `b_specs`
    is split over the data axes (each rank its rows) or replicated."""
    split = b_specs["tokens"][0] is not None
    if split == model.mesh_ctx.tokens_sharded:
        return model
    out = copy.copy(model)
    out.mesh_ctx = dataclasses.replace(model.mesh_ctx, tokens_sharded=split)
    return out


class TrainLog:
    """Host-side record of one run, with the paper's balance metrics: per
    step CE loss, perplexity, wall time and per-layer MaxVio, accumulated
    into per-layer and model-level AvgMaxVio / SupMaxVio; `events` holds
    the guard ladder's and the loop's events."""

    def __init__(self) -> None:
        self.losses: List[float] = []
        self.perplexities: List[float] = []
        self.step_times: List[float] = []
        self.max_vio_steps: List[np.ndarray] = []
        self.per_layer: List[BalanceTracker] = []
        self.model_tracker = BalanceTracker()
        self.events: List[Dict[str, Any]] = []
        self.checkpoints: List[Dict[str, Any]] = []  # CheckpointManager.saves of the run

    def __len__(self) -> int:
        return len(self.losses)

    def _track(self, vios: np.ndarray) -> None:
        if not self.per_layer:
            self.per_layer = [BalanceTracker() for _ in range(vios.size)]
        for t, v in zip(self.per_layer, vios):
            t.add(float(v))
        # model-level MaxVio for the batch = max over layers (conservative)
        self.model_tracker.add(float(vios.max()))

    def record(self, mets: Dict[str, Any], dt: float) -> None:
        self.losses.append(float(mets["ce_loss"]))
        self.perplexities.append(float(mets["perplexity"]))
        self.step_times.append(dt)
        vios = mets.get("max_vio_per_layer")
        vios = np.zeros(0) if vios is None else np.asarray(torch.as_tensor(vios).cpu(), np.float64)
        if vios.size:
            self.max_vio_steps.append(vios)
            self._track(vios)

    def truncate(self, n: int) -> None:
        """Drop the records past the first `n` steps and rebuild the balance
        trackers from the rest: a rollback rewinds the log, so replayed
        steps are not counted twice in AvgMaxVio/SupMaxVio."""
        n = max(0, n)
        del self.losses[n:], self.perplexities[n:], self.step_times[n:], self.max_vio_steps[n:]
        self.per_layer = []
        self.model_tracker = BalanceTracker()
        for vios in self.max_vio_steps:
            self._track(vios)

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
        if self.events:
            out["guard_events"] = list(self.events)
        return out


def train_loop(
    model: Model,
    batches: Iterable[Dict[str, Any]],
    *,
    seed: int = 0,
    lr: float = 3e-4,
    warmup_steps: int = 20,
    total_steps: int = 200,
    log_every: int = 0,
    state: Optional[TrainState] = None,
    microbatches: int = 1,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
    async_ckpt: bool = True,
    guard=None,
    faults=None,
    telemetry: Optional[TrainTelemetry] = None,
    mesh=None,
) -> Tuple[TrainState, TrainLog]:
    """Host loop of one device, or of one rank of a mesh: the reference's
    schedule wiring (AdamW from the model config, linear warmup then cosine
    to 10% of `lr`), stopping
    at `total_steps` even for an endless stream (it never pulls a batch it
    will not train on). Each step's wall time is taken around work that
    ends in reading the loss, so it covers the device work of the step.
    Batches may hold numpy arrays (the text loader's) or tensors; they go
    to the model's device as int64.

    `batches` with state_dict/load_state_dict (`data.ShardedTextLoader`,
    `data.SyntheticBatchStream`, a `data.Prefetcher` around either) has its
    cursor checkpointed beside the TrainState, and `resume=True` seeks it
    in O(1); a plain iterable is replay-skipped past the restored steps.

    * `ckpt_dir` / `ckpt_every`: save every N steps (and the final state
      off a boundary) through `checkpoint.CheckpointManager`, asynchronously
      unless `async_ckpt=False` (an on-device snapshot, then a writer
      thread; checkpoints are durable when the loop returns).
    * `resume=True` restores the newest VALID checkpoint under `ckpt_dir`
      (corrupt ones are skipped with a warning) and continues.
    * `guard` (a `robustness.GuardConfig`) runs the guarded step and the
      host's skip -> reduce-LR -> rollback ladder; a rollback restores the
      newest valid checkpoint, rewinds the stream, truncates the log and
      replays with the bad step force-skipped (bit-identical to skipping it
      in place). Rollback needs a checkpoint directory, `ckpt_every` and a
      rewindable stream; without them the ladder raises TrainingDiverged.
    * `faults` (a `robustness.FaultPlan`) drives the injection seams: the
      NaN into the guarded step, corruption after a save.
    * SIGTERM (installed on the main thread when checkpointing) writes one
      final SYNCHRONOUS checkpoint and returns; the handler is restored on
      exit.
    * `telemetry` (a `telemetry.TrainTelemetry`) gets each step's metrics
      in its device ring, the step's wall time, the guard ladder's and the
      loop's events as they happen (each once, in order), and drives its
      profiler window; its partial last window is drained in the `finally`
      block. Closing the sink is the caller's job.
    * `mesh` (a DeviceMesh; the model from `build_model(cfg,
      make_mesh_ctx(mesh))`): every rank runs this loop on the same global
      batches; a given `state` is the whole one and is cut to the rank's
      blocks (`distributed.shard_tree`), a fresh one is initialised whole
      and cut, each batch is cut to the rank's rows (`shard_batch`), and
      the returned state holds the rank's blocks (`distributed.unshard_tree`
      gathers them). Checkpoints are collectives there (every rank saves
      and restores at the same step; rank 0 writes), and the SIGTERM flag
      is agreed over the mesh (a max) at each step boundary, so a rank
      that did not get the signal saves with the others.
    """
    opt_cfg = _adamw.from_model_config(model.cfg)
    # the step is built before any data is read: a bad microbatch count fails first
    guarded = guard is not None or (faults is not None and faults.get("nan_grad") is not None)
    lr_fn = linear_warmup_cosine(lr, warmup_steps, total_steps)
    step_fn = None
    if mesh is None:
        step_fn = make_train_step(model, opt_cfg, lr_fn, microbatches=microbatches, guarded=guarded,
                                  telemetry=telemetry)
    elif microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    lead = mesh is None or torch.distributed.get_rank() == 0  # the rank that writes on a mesh

    manager = None
    if ckpt_dir is not None:
        from repro_torch.checkpoint import CheckpointManager

        manager = CheckpointManager(ckpt_dir)

    is_stream = hasattr(batches, "state_dict") and hasattr(batches, "load_state_dict")
    start_step = 0
    data_state = None
    sharded = False  # the state holds this rank's blocks already
    if resume and manager is not None and state is None:
        from repro_torch.checkpoint import latest_step

        if mesh is not None:
            got = manager.restore_sharded(model.cfg, mesh, device=model.device)
            if got is not None:
                start_step, state = got
                sharded = True
        elif latest_step(ckpt_dir) is not None:
            start_step, state = manager.restore_train_state(model.cfg, device=model.device)
        if state is not None:
            data_state = manager.restore_data_state(start_step)
    st_specs = b_specs = None
    if mesh is not None:
        if state is None:  # initialised whole, then cut; the moments start as blocks
            params = shard_tree(model.init(seed), model.mesh_ctx.param_specs, mesh)
            state = TrainState(params, _adamw.adamw_init(params, opt_cfg), model.init_router_states())
        elif not sharded:
            state = shard_tree(state, train_state_specs(state, model.cfg, mesh), mesh)
        st_specs = _state_specs(model, state)
    elif state is None:
        state = init_train_state(model, seed, opt_cfg)

    def restore():
        """The newest valid checkpoint, as this loop holds its state."""
        if mesh is None:
            return manager.restore_train_state(model.cfg, device=model.device)
        return manager.restore_sharded(model.cfg, mesh, device=model.device)

    loop_start = 0  # the step index the loop starts at
    if is_stream and data_state is not None:
        batches.load_state_dict(data_state)  # O(1) seek past the consumed prefix
        loop_start = start_step

    tguard = None
    if guarded:
        tguard = TrainGuard(
            guard if guard is not None else GuardConfig(),
            can_rollback=manager is not None and is_stream and ckpt_every > 0,
        )

    # preemption: SIGTERM asks for one final synchronous checkpoint; signal
    # handlers can only be installed on the main thread
    sig_flag = {"term": False}
    prev_handler = None
    hook_signal = manager is not None and threading.current_thread() is threading.main_thread()
    if hook_signal:
        prev_handler = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: sig_flag.update(term=True))

    log = TrainLog()
    saved_at = -1
    emitted = {"n": 0}

    def event(ev: Dict[str, Any]) -> None:
        if telemetry is not None:
            telemetry.event(ev)

    def stream_events() -> None:
        # forward the guard ladder's new events to the telemetry sink,
        # exactly once each, in order
        if telemetry is None or tguard is None:
            return
        while emitted["n"] < len(tguard.events):
            telemetry.event(dict(tguard.events[emitted["n"]]))
            emitted["n"] += 1

    def save(block: bool) -> None:
        path = manager.save_train_state(
            state, model.cfg, data_state=batches.state_dict() if is_stream else None, block=block,
            mesh=mesh, specs=st_specs,
        )
        if lead and faults is not None and faults.get("ckpt_corrupt") is not None:
            manager.wait()  # the file must be fully written before corrupting
            if faults.corrupt_after_save(path):
                ev = {"step": i, "kind": "ckpt_corrupted", "path": path}
                log.events.append(ev)
                event(ev)

    try:
        it = iter(batches)
        i = loop_start - 1
        while True:
            # bound infinite streams BEFORE pulling: the stream's cursor must
            # stay in step with the step count
            if total_steps and i + 1 >= total_steps:
                break
            try:
                batch = next(it)
            except StopIteration:
                break
            i += 1
            if i < start_step:
                continue  # resumed plain iterable: replay-skip the consumed prefix
            batch = batch_to_torch(batch, model.device)
            if mesh is not None:
                if step_fn is None:
                    b_specs = micro_layout(model.cfg, mesh, batch, microbatches)
                    step_fn = compile_train_step(model, opt_cfg, lr_fn, state, batch, mesh=mesh,
                                                 microbatches=microbatches, st_specs=st_specs,
                                                 b_specs=b_specs, guarded=guarded, telemetry=telemetry)
                batch = shard_batch(batch, b_specs, mesh, microbatches)
            if telemetry is not None:
                telemetry.before_step(i)  # the profiler window, if configured
            t0 = time.perf_counter()
            args = (state, batch)
            if guarded:
                force_skip, lr_scale = tguard.controls(i)
                inject = faults is not None and faults.nan_fires(i)
                args += ((float(inject), float(force_skip), lr_scale),)
            if telemetry is not None:
                state, mets, _ = step_fn(*args, telemetry.buf, i)
            else:
                state, mets = step_fn(*args)
            loss = float(mets["loss"])  # wait for the step's device work
            dt = time.perf_counter() - t0
            if telemetry is not None:
                telemetry.note_step_time(i, dt)
                # before the guard observes: a rolled-back step's row is kept
                telemetry.after_step(i)
            if guarded:
                action = tguard.observe(i, loss, bool(mets["step_ok"]))  # raises on RAISE
                log.events = tguard.events
                stream_events()
                if action == ROLLBACK:
                    r_step, state = restore()
                    ds = manager.restore_data_state(r_step)
                    if ds is None:
                        raise TrainingDiverged(
                            f"rollback to step {r_step}: checkpoint has no data cursor "
                            f"to rewind the stream with"
                        )
                    if hasattr(batches, "close"):
                        batches.close()  # a Prefetcher must re-arm after the rewind
                    batches.load_state_dict(ds)
                    it = iter(batches)
                    log.truncate(r_step - loop_start)
                    log.events = tguard.events
                    stream_events()
                    event({"step": i, "kind": "rollback_replay", "to_step": r_step})
                    start_step = 0  # a fallback restore may predate `resume`
                    i = r_step - 1
                    if log_every:
                        print(f"rollback -> step {r_step} (replaying)")
                    continue
            log.record(mets, dt)
            if log_every and i % log_every == 0:
                vio = f" maxvio {log.max_vio_steps[-1].max():.3f}" if log.max_vio_steps else ""
                print(f"step {i:5d} loss {log.losses[-1]:.4f} ppl {log.perplexities[-1]:.2f}{vio}")
            if manager is not None and ckpt_every and (i + 1) % ckpt_every == 0:
                save(block=not async_ckpt)
                saved_at = i
            term = sig_flag["term"]
            if mesh is not None and manager is not None:  # every rank saves, or none
                with collectives.axis_env(mesh):
                    flag = torch.tensor(float(term), device=model.device)
                    term = bool(collectives.pmax(flag, tuple(mesh.mesh_dim_names)) > 0)
            if term:
                save(block=True)  # preemption: make the state durable NOW
                saved_at = i
                ev = {"step": i, "kind": "sigterm_checkpoint"}
                log.events.append(ev)
                event(ev)
                break
        if manager is not None and ckpt_every and saved_at != i:
            save(block=not async_ckpt)  # final state, off-boundary stop
    finally:
        if telemetry is not None:
            telemetry.finish()  # the partial window and the copies in flight
        if hook_signal:
            signal.signal(signal.SIGTERM, prev_handler)
        if manager is not None:
            manager.wait()  # checkpoints durable before the loop returns
        if hasattr(batches, "close"):
            batches.close()  # stop a Prefetcher's producer on early break
    log.checkpoints = manager.saves if manager is not None else []
    return state, log


@torch.no_grad()
def evaluate_ppl(model: Model, state: TrainState, batches) -> float:
    """Test perplexity with the routing states frozen (each batch routes from
    the trained states; their updates are dropped). Per-batch CE means are
    weighted by each batch's count of valid labels."""
    mesh = model.mesh_ctx.mesh
    ces, ns = [], []
    for batch in batches:
        batch = batch_to_torch(batch, model.device)
        ns.append(int((batch["labels"] >= 0).sum()))
        run = model
        if mesh is not None:  # a rank of a mesh: its rows, and its blocks of the state
            b_specs = batch_layout(model.cfg, mesh, batch)
            run = _on_batch_layout(model, b_specs)
            batch = shard_tree(batch, b_specs, mesh)
        _, (_, mets) = run.loss_fn(state.params, batch, state.router_states)
        ces.append(float(mets["ce_loss"]))
    return float(np.exp(np.average(ces, weights=ns)))
