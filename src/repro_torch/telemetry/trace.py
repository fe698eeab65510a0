"""Tracing plane: span annotations and profiler capture windows (port of
src/repro/telemetry/trace.py).

One naming convention, "area/phase", lowercase, slash separated (e.g.
"router/score_adjust", "moe/gemm", "train/fwd_bwd"). The reference has two
span kinds, one that names traced ops inside jit and one for host-side
Python phases; the port is eager, so both names give a
`torch.profiler.record_function` span, a host range on the profiler's
timeline that the kernels launched under it are attributed to.

Nothing with no profiler: while no profiler is collecting
(`torch.autograd._profiler_enabled()` is False), `named_span` and
`trace_span` return one shared no-op context and `layer_span` calls its
function and nothing else, so a step outside a capture makes no
`record_function` call, no autograd node and no hook.

Layer spans. `layer_span(name, fn, *args)` runs `fn` under the span `name`
and, while a profiler is collecting, ties the backward of that region to
its layer: `bwd/<name>` is the backward of the layer span `name`. It opens
on autograd's thread when the gradient of one of the region's outputs is
whole, and closes when that of one of its computed inputs is: a pre-hook on
the node that made each such tensor, which launches nothing (a region that
takes only weights closes in an identity node on them). The engine runs the
backward in the reverse of the order the forward made its nodes, so the
nodes of a region run together, after its outputs' nodes and before its
inputs' (the weights' gradients included); where one region's output is the
next one's input, the hook closes the later region's twin before it opens
the earlier one's. So the twin nests inside any span open on that thread,
and nested regions nest their twins. A region whose inputs carry no
gradient gets no twin; the forward that `torch.utils.checkpoint` replays
inside the backward gets neither span (its kernels count to the twin that
replays it). Values and gradients are bit-identical with and without a
profiler (the identity node pre-sums what the region adds into each
weight, so a weight-only region reads each weight once).

The training step's layer spans (models/): the partition, which does not
nest and covers the forward, is

    model/embed      the token gather and the vlm prefix projection
    model/attention  pre-norm, attention, optional post-norm, residual add
    model/mamba      pre-norm, the mamba mixer, residual add
    model/ffn        ffn norm, the dense MLP or the MoE FFN with its
                     residual MLPs, optional post-norm, residual add
    model/head       the final norm and the unembedding
    model/loss       the logits to the loss, the balancers' aux loss added

each with its `bwd/` twin; `model/weight_cast` (and its twin) nests inside
them around each compute-dtype cast of weights (`common.cast_weights`, a
`cast_span`: one node per use site whose backward runs its twin).
The forward spans `router/*`, `moe/*`, `train/*` and `telemetry/accumulate`
have no twin.

`profile_window("N:M")` parses the launchers' `--profile` flag; `Profiler`
starts a `torch.profiler.profile` when the step counter enters [N, M],
stops after M and writes a Chrome trace, so a capture costs nothing
outside its window.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, List, Optional, Tuple

import torch

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def named_span(name: str):
    """Profiler span around the ops a phase launches (the reference's
    in-graph scope); a shared no-op context with no profiler."""
    return torch.profiler.record_function(name) if _profiling() else _OFF


def trace_span(name: str):
    """Profiler span around a host-side phase (engine step, flush); a
    shared no-op context with no profiler."""
    return torch.profiler.record_function(name) if _profiling() else _OFF


class _Twin:
    """The `bwd/<name>` range of one region, opened and closed on autograd's
    thread."""

    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name
        self.record = None

    def open(self) -> None:
        if self.record is None:
            self.record = torch.ops.profiler._record_function_enter_new(self.name, None)

    def close(self) -> None:
        if self.record is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(self.record)
            self.record = None


class _Edge:
    """A pre-hook on the node that made a tensor: it runs when the tensor's
    gradient is whole, and first closes the twins of the regions that took
    the tensor in, then opens those of the regions that gave it out."""

    __slots__ = ("closes", "opens")

    def __init__(self):
        self.closes: List[_Twin] = []
        self.opens: List[_Twin] = []

    def __call__(self, grad_outputs):
        for twin in self.closes:
            twin.close()
        for twin in self.opens:
            twin.open()


def _edge(t: torch.Tensor) -> _Edge:
    edge = getattr(t, "_twin_edge", None)
    if edge is None:
        edge = t._twin_edge = _Edge()
        t.grad_fn.register_prehook(edge)
    return edge


class _Exit(torch.autograd.Function):
    """Identity on the weights of a region that takes no computed input: its
    backward closes the twin."""

    @staticmethod
    def forward(ctx, twin, *ts):
        ctx.twin = twin
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        ctx.twin.close()
        return (None, *grads)


class _Cast(torch.autograd.Function):
    """`t.to(dtype)` of each t, whose backward, the gradients cast back, runs
    under the twin."""

    @staticmethod
    def forward(ctx, twin_name, dtype, *ts):
        ctx.twin_name, ctx.dtypes = twin_name, [t.dtype for t in ts]
        ctx.set_materialize_grads(False)
        outs = [t.to(dtype) for t in ts]
        return tuple(t.view_as(t) if o is t else o for t, o in zip(ts, outs))

    @staticmethod
    def backward(ctx, *gs):
        with torch.profiler.record_function(ctx.twin_name):
            return (None, None, *(None if g is None else g.to(d) for g, d in zip(gs, ctx.dtypes)))


def _leaves(tree, out: List[torch.Tensor]) -> None:
    """The tensors of a tree of dicts, lists and tuples that need a gradient."""
    if isinstance(tree, torch.Tensor):
        if tree.requires_grad:
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)


def _swap(tree, new: dict):
    """`tree` with each tensor whose id is in `new` replaced by its value."""
    if isinstance(tree, torch.Tensor):
        return new.get(id(tree), tree)
    if isinstance(tree, dict):
        return {k: _swap(v, new) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_swap(v, new) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_swap(v, new) for v in tree)
    return tree


def layer_span(name: str, fn: Callable[..., Any], *args, **kwargs):
    """`fn(*args, **kwargs)` as the layer region `name`: under the span
    `name`, with its backward under `bwd/<name>` (see the module doc).
    Every tensor the region needs a gradient for is passed in `args` or
    `kwargs` (dicts, lists and tuples of tensors are walked), not captured
    by `fn`. With no profiler it is `fn(*args, **kwargs)`."""
    if not _profiling() or torch._C._current_graph_task_id() != -1:
        return fn(*args, **kwargs)  # no profiler, or a forward replayed inside the backward
    with torch.profiler.record_function(name):
        ins: List[torch.Tensor] = []
        if torch.is_grad_enabled():
            _leaves((args, kwargs), ins)
        if not ins:
            return fn(*args, **kwargs)
        twin = _Twin("bwd/" + name)
        computed = [t for t in ins if t.grad_fn is not None]
        for t in computed:
            _edge(t).closes.append(twin)
        if not computed:
            views = _Exit.apply(twin, *ins)
            args, kwargs = _swap((args, kwargs), {id(t): v for t, v in zip(ins, views)})
        out = fn(*args, **kwargs)
        outs: List[torch.Tensor] = []
        _leaves(out, outs)
        taken = {id(t) for t in ins}
        for t in outs:
            if t.grad_fn is not None and id(t) not in taken:
                _edge(t).opens.append(twin)
        return out


def cast_span(name: str, dtype: torch.dtype, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """`tuple(t.to(dtype) for t in ts)` as the layer region `name` in one
    autograd node, for the many small regions that are casts alone: its
    backward, each gradient cast back to its t's dtype (what `.to`'s own
    backward computes), runs under `bwd/<name>`. With no profiler it is the
    plain casts."""
    if not _profiling() or torch._C._current_graph_task_id() != -1:
        return tuple(t.to(dtype) for t in ts)
    with torch.profiler.record_function(name):
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)):
            return tuple(t.to(dtype) for t in ts)
        return _Cast.apply("bwd/" + name, dtype, *ts)


def profile_window(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse a --profile 'N:M' flag into an inclusive (start, stop) window."""
    if not spec:
        return None
    try:
        lo_s, hi_s = spec.split(":")
        lo, hi = int(lo_s), int(hi_s)
    except ValueError as e:
        raise ValueError(f"--profile expects 'N:M' (got {spec!r})") from e
    if lo < 0 or hi < lo:
        raise ValueError(f"--profile window must satisfy 0 <= N <= M (got {spec!r})")
    return lo, hi


class Profiler:
    """Capture a torch.profiler trace of steps N..M (inclusive).

    Call `step(i)` with the current step index before each step; the
    capture starts on entering the window and stops when a step past it
    begins (or at `close()` if the run ends inside it), then writes
    `<log_dir>/steps_N-M.pt.trace.json` (Chrome trace format; `trace_path`
    holds the name). Device activity is recorded when CUDA is available.
    Idempotent and inert when window is None.
    """

    def __init__(self, window: Optional[Tuple[int, int]], log_dir: str = "profile"):
        self.window = window
        self.log_dir = log_dir
        self.trace_path: Optional[str] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self, i: int) -> None:
        if self.window is None:
            return
        lo, hi = self.window
        if not self.active and lo <= i <= hi:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.log_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif self.active and i > hi:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's kernels end inside the capture
        prof, self._prof = self._prof, None
        prof.stop()
        lo, hi = self.window
        self.trace_path = os.path.join(self.log_dir, f"steps_{lo}-{hi}.pt.trace.json")
        prof.export_chrome_trace(self.trace_path)


__all__ = ["Profiler", "cast_span", "layer_span", "named_span", "profile_window", "trace_span"]
