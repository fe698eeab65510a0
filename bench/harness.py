"""One benchmark cell of the port's training step: set-up, the measured (or
traced) window, and the comparison with the plain reference.

A cell (an entry of BENCHMARK.json's workloads) names a configuration
(`configs/<name>.json`: the port's registry id, the published sizes, and
the name of its plain reference, `reference/<reference>.py`, which also
lays out the parameter tree (`leaf_specs`), counts the model's FLOPs
(`model_flops_per_token`) and records the q and loads of the layers that
have a router), a traffic mix (`traffic/<name>.json`: batch, sequence
length, token statistics, the routing path, the optimizer and schedule,
the pool of batches and the checked and traced steps), and its limits
(`limits/<cell>.json`). Per-layer metrics are read by
`metrics/<metric>.py`. Everything is found by name; nothing here names a
leaf or a layer kind of any model.

Set-up builds the port's model and AdamW state around weights made from the
seed (inputs.py), makes the pool of batches, and drives the port's train
step (`training.loop.make_train_step`, unguarded, no telemetry, as
`train_loop` calls it) through the mix's checked steps; those warm every
shape and are what the reference follows. The window then drives the same
step object over the pool's further batches, with one CUDA event after each
step and one synchronise at its end; the step metrics stay on the device
until then. The traced run puts the mix's traced steps under torch.profiler
instead. Once the window has closed and the program's state is freed, the
reference runs the checked steps again from regenerated weights, and
check.py compares the two.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from bench import check, inputs, tracing

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict       # configs/<config>.json
    mix: dict          # traffic/<traffic>.json
    limits: dict       # limits/<cell>.json ({} where the cell has none yet)
    end_to_end: List[dict]
    per_layer: List[dict]
    reference: str     # the plain reference's module: bench.reference.<the file's "reference">

    @property
    def tokens_per_step(self) -> int:
        return self.mix["batch"] * self.mix["seq_len"]


def resolve(name: str, spec: Optional[dict] = None, base: Path = BENCH) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `spec`), from its files: the
    configuration's file as the spec names it, the mix and limits under
    `base`."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    limits_path = base / "limits" / f"{name}.json"
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    doc = load_json(ROOT / conf["file"])
    return Cell(
        name=name, chips=w["chips"], config=doc,
        mix=load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.exists() else {},
        end_to_end=e2e, per_layer=layer, reference=f"bench.reference.{doc['reference']}",
    )


def reference(cell: Cell):
    """The cell's plain reference module."""
    return importlib.import_module(cell.reference)


def weights(cell: Cell, seed: int, device) -> Dict:
    """The seed's fp32 weights in the tree the cell's reference lays out."""
    return inputs.make_params(reference(cell).leaf_specs(cell.config["config"]), seed, device)


# ------------------------------------------------------------------ the port


def _as_file(v):
    """A field of the port's config as the JSON file writes it."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, tuple):
        return [_as_file(x) for x in v]
    return v


def _as_port(have, value):
    """The file's `value` in the type of the port's field `have`: a nested
    spec (a dataclass) takes the keys the value gives, key by key."""
    if dataclasses.is_dataclass(have):
        return dataclasses.replace(have, **{k: _as_port(getattr(have, k), v) for k, v in value.items()})
    if isinstance(have, torch.dtype):
        return getattr(torch, value)
    if isinstance(have, tuple):
        return tuple(value)
    return value


def _held(doc: dict, have, want: dict, prefix: str = "") -> dict:
    """The file's values that the port takes (the keys `reduced` lists, by
    dotted name or by a whole group), as a nested dict; ValueError naming
    the dotted key where any other value the file states is not the port's."""
    take = {}
    for key, value in want.items():
        label, field = prefix + key, getattr(have, key)
        if label in doc["reduced"]:
            take[key] = value
        elif dataclasses.is_dataclass(field) and isinstance(value, dict):
            inner = _held(doc, field, value, label + ".")
            if inner:
                take[key] = inner
        elif _as_file(field) != value:
            raise ValueError(f"{doc['name']}: the port's config {doc['registry']!r} has "
                             f"{label} = {_as_file(field)!r}, bench's file states {value!r}")
    return take


def port_config(doc: dict, mix: dict):
    """The port's registry config for `doc`, held to the file: every size
    the file states, in nested specs key by key, must be the port's, except
    the keys listed in `reduced` (top-level or dotted, `routing.n_experts`),
    which take the file's value (ValueError naming the key otherwise). The
    mix's routing path (strategy, sync, kernels), where it gives one, is
    applied after."""
    from repro_torch import configs

    cfg = configs.get(doc["registry"])
    take = _held(doc, cfg, doc["config"])
    if "routing" in mix:
        take["routing"] = {**take.get("routing", {}), **mix["routing"]}
    return _as_port(cfg, take)


@dataclasses.dataclass
class Program:
    """The port's training step around the benchmark's inputs."""
    state: object
    step: Callable
    pool: torch.Tensor


def build_program(cell: Cell, seed: int, device) -> Program:
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import linear_warmup_cosine
    from repro_torch.training.loop import TrainState, make_train_step

    cfg = port_config(cell.config, cell.mix)
    model = Model(cfg, device=device)
    t = time.monotonic()
    params = weights(cell, seed, device)
    _sync(device)
    log(f"set-up: weights {time.monotonic() - t:.2f} s (with the device's first use)")
    opt_cfg = adamw.from_model_config(cfg, **cell.mix["adamw"])
    mix = cell.mix
    lr_fn = linear_warmup_cosine(mix["lr"], mix["warmup_steps"], mix["total_steps"])
    state = TrainState(params, adamw.adamw_init(params, opt_cfg), model.init_router_states())
    t = time.monotonic()
    pool = inputs.batch_pool(cfg.vocab_size, mix, seed, device)
    log(f"set-up: batch pool {time.monotonic() - t:.2f} s")
    return Program(state, make_train_step(model, opt_cfg, lr_fn), pool)


def checked_steps(prog: Program, cell: Cell, seed: int, device) -> Dict:
    """The mix's checked steps through the program, recorded in
    reference.train_steps' layout (one host read at the end): q and the
    loads of the layers with a router state, in layer order; none where no
    layer has one."""
    from repro_torch.optim.adamw import tree_leaves

    rec = {"loss": [], "q": [], "load": []}
    b1 = cell.mix["adamw"]["b1"]
    for i in range(cell.mix["checked_steps"]):
        prog.state, mets = prog.step(prog.state, inputs.batch(prog.pool, i))
        rec["loss"].append(mets["loss"])
        qs = [st["q"] for st in prog.state.router_states if st is not None]
        if qs:
            rec["q"].append(torch.stack(qs))
        if "load_per_layer" in mets:
            rec["load"].append(mets["load_per_layer"])
        if i == 0:  # the gradient as AdamW took it: mu after one step, over (1 - b1)
            mu = tree_leaves(prog.state.opt_state["mu"])
            rec["grad_norms"] = torch.stack([torch.linalg.vector_norm(t) for t in mu]) / (1 - b1)
    with torch.no_grad():
        p0 = tree_leaves(weights(cell, seed, device))
        rec["update_norms"] = torch.stack([torch.linalg.vector_norm(p - q)
                                           for p, q in zip(tree_leaves(prog.state.params), p0)])
        del p0
    return {"loss": [float(v) for v in rec["loss"]], "q": [t.cpu() for t in rec["q"]],
            "load": [t.cpu() for t in rec["load"]], "grad_norms": rec["grad_norms"].tolist(),
            "update_norms": rec["update_norms"].tolist()}


def reference_records(cell: Cell, seed: int, pool: torch.Tensor, device, precision: str = "fp32") -> Dict:
    """The plain reference through the same checked steps from the same inputs."""
    params = weights(cell, seed, device)
    batches = [inputs.batch(pool, i) for i in range(cell.mix["checked_steps"])]
    return reference(cell).train_steps(params, batches, cell.config["config"], cell.mix, precision)


# ------------------------------------------------------------------ windows


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_window(prog: Program, cell: Cell, seconds: float, device) -> Dict:
    """Steps over the pool's further batches until `seconds` have passed on
    the host; each step's end is a CUDA event (on the CPU, the host clock).
    Returns the end-to-end measures."""
    cuda = torch.device(device).type == "cuda"
    first = cell.mix["checked_steps"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _sync(device)
    marks, losses = [], []
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    while time.perf_counter() - t0 < seconds or not marks:
        prog.state, mets = prog.step(prog.state, inputs.batch(prog.pool, first + len(marks)))
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        losses.append(mets["loss"])
    _sync(device)
    window_s = time.perf_counter() - t0
    if cuda:
        ends = [start.elapsed_time(e) * 1e-3 for e in marks]
        peak = torch.cuda.max_memory_allocated()
    else:
        ends = [t - t0 for t in marks]
        peak = 0
    step_s = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    loss = torch.stack(losses)
    return {
        "steps": len(marks),
        "window_s": window_s,
        "train_tokens_per_s": len(marks) * cell.tokens_per_step / window_s,
        "step_ms_p90": 1e3 * statistics.quantiles(step_s, n=10)[-1] if len(step_s) > 1 else 1e3 * step_s[0],
        "peak_mem_gib": peak / GIB,
        "memory_peak_bytes": peak,
        "failed": int((~torch.isfinite(loss)).sum()),
    }


def traced_window(prog: Program, cell: Cell, device) -> Dict:
    """The mix's traced steps under torch.profiler (host and device), after
    one traced step that is left out; returns tracing.read's records plus
    the steps, the router layers' loads and MaxVio (none without a router
    layer), the configuration and its reference's module."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    first = cell.mix["checked_steps"]
    n = cell.mix["traced_steps"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _sync(device)
    loads, vios, losses = [], [], []
    with profile(activities=acts) as prof:
        prog.state, _ = prog.step(prog.state, inputs.batch(prog.pool, first))
        _sync(device)
        with record_function(tracing.WINDOW_SPAN):
            for i in range(n):
                prog.state, mets = prog.step(prog.state, inputs.batch(prog.pool, first + 1 + i))
                if "load_per_layer" in mets:
                    loads.append(mets["load_per_layer"])
                    vios.append(mets["max_vio_per_layer"])
                losses.append(mets["loss"])
            _sync(device)
    rec = tracing.read(prof)
    rec.update(steps=n, loads=[t.cpu() for t in loads], max_vio=[t.cpu() for t in vios],
               failed=int((~torch.isfinite(torch.stack(losses))).sum()),
               config=cell.config["config"], reference=cell.reference, mix=cell.mix,
               tokens_per_step=cell.tokens_per_step,
               memory_peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
    return rec


def read_metric(name: str, rec: Dict) -> Optional[float]:
    """bench/metrics/<name>.py's reading of a traced run (None: nothing to read)."""
    mod = importlib.import_module(f"bench.metrics.{name}")
    return mod.read(rec)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --------------------------------------------------------------------- a run


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             fault: Optional[Callable] = None) -> Dict:
    """One run of the cell: the result line's dict, with 'checks' (each
    compared number beside its limit) last. `fault` wraps the program's
    step (bench/faults.py), to see the comparison reject a broken path."""
    log(f"set-up: process start to building the program {time.monotonic() - t_start:.2f} s")
    t = time.monotonic()
    import repro_torch.training.loop  # noqa: F401  (the port's import, timed apart)
    log(f"set-up: importing the port {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    prog = build_program(cell, seed, device)
    if fault is not None:
        prog.step = fault(prog.step)
    log(f"set-up: model, weights, AdamW state, batch pool {time.monotonic() - t:.2f} s")
    t = time.monotonic()
    prog_rec = checked_steps(prog, cell, seed, device)
    _sync(device)
    setup_s = time.monotonic() - t_start
    log(f"set-up: {cell.mix['checked_steps']} checked steps {time.monotonic() - t:.2f} s; "
        f"setup_s {setup_s:.2f} s")

    t = time.monotonic()
    measured = traced_window(prog, cell, device) if trace else timed_window(prog, cell, seconds, device)
    log(f"window: {measured['steps']} steps, "
        f"{time.monotonic() - t:.2f} s with {'reading the trace' if trace else 'the final synchronise'}")
    pool = prog.pool
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t = time.monotonic()
    ref_rec = reference_records(cell, seed, pool, device)
    log(f"reference: {cell.mix['checked_steps']} steps {time.monotonic() - t:.2f} s")
    nums = check.numbers(prog_rec, ref_rec)
    failed = measured["failed"]
    correct = bool(cell.limits) and failed == 0 and check.verdict(nums, cell.limits)

    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": measured["memory_peak_bytes"]}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        dev.update(busy_s=measured["busy_s"], window_s=measured["window_s"])
        values = {m["name"]: read_metric(m["name"], measured) for m in cell.per_layer}
    else:
        measured["setup_s"] = setup_s
        values = {m["name"]: measured[m["name"]] for m in cell.end_to_end}
    out = {
        "correct": correct,
        "attempted": measured["steps"],
        "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None},
        "device": dev,
    }
    if trace:
        out["breakdown"] = tracing.breakdown(measured)
    out["checks"] = {k: {"value": nums.get(k, math.inf), "limit": lim["limit"]}
                     for k, lim in cell.limits.items()}
    return out


def check_lines(result: Dict) -> List[str]:
    """Each compared number beside its limit, for the end of standard error."""
    return [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in result["checks"].items()]

