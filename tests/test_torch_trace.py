"""The layer spans of the port's training step (telemetry/trace.py): a
profiled step of reduced minimind-moe-16e (bip, the plain CPU path) holds
each partition span and its `bwd/` twin once per layer, the twins nest on
their thread and cover the backward, values and gradients are bitwise the
same with the profiler on and off, and with it off nothing is recorded."""
from __future__ import annotations

import collections
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.models import Model, common  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.telemetry.trace import layer_span, named_span, trace_span  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training.loop import TrainState  # noqa: E402

ARCH = "minimind_moe_16e"
PER_LAYER = ("model/attention", "model/ffn")
PER_STEP = ("model/embed", "model/head", "model/loss")


def _setup(**fields):
    full = configs.get(ARCH)
    cfg = configs.reduced_for_smoke(ARCH, routing=dataclasses.replace(full.routing, strategy="bip"),
                                    vocab_size=128)
    cfg = dataclasses.replace(cfg, **fields)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    opt = adamw.from_model_config(cfg)
    state = TrainState(params, adamw.adamw_init(params, opt), model.init_router_states())
    step = make_train_step(model, opt, schedules.linear_warmup_cosine(1e-3, 1, 10))
    batch = next(iter(make_batches(cfg, 4, 32, 1)))
    return model, state, step, batch


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def _spans(events):
    return [e for e in events if getattr(e, "is_user_annotation", False)]


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def test_partition_spans_and_twins_once_per_layer():
    model, state, step, batch = _setup()
    _, events = _profiled(lambda: step(state, batch))
    spans = _spans(events)
    count = collections.Counter(e.name for e in spans)
    n = model.cfg.n_layers
    for name in PER_LAYER:
        assert count[name] == count["bwd/" + name] == n, (name, count)
    for name in PER_STEP:
        assert count[name] == count["bwd/" + name] == 1, (name, count)
    # one cast site per block: attention's four, the shared expert's three,
    # the routed experts' three per layer; the tied table in embed and unembed
    assert count["model/weight_cast"] == count["bwd/model/weight_cast"] == 3 * n + 2
    assert not [k for k in count if k.startswith("bwd/") and k[4:] not in count]

    # each twin nests in every other span of its thread, with no partial overlap
    for b in (e for e in spans if e.name.startswith("bwd/")):
        b0, b1 = b.time_range.start, b.time_range.end
        assert b1 > b0
        for o in spans:
            if o is b or o.thread != b.thread:
                continue
            o0, o1 = o.time_range.start, o.time_range.end
            assert o1 <= b0 or o0 >= b1 or (o0 <= b0 and b1 <= o1) or (b0 <= o0 and o1 <= b1), \
                (b.name, o.name, (b0, b1), (o0, o1))

    # the backward's op self-time lies under the twins
    total = under = 0.0
    for e in events:
        if getattr(e, "is_user_annotation", False) or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        chain = list(_ancestors(e))
        if not any(a.name.startswith("autograd::engine::evaluate_function") for a in chain):
            continue
        total += e.self_cpu_time_total
        if any(a.name.startswith("bwd/") for a in chain):
            under += e.self_cpu_time_total
    assert total > 0 and under / total >= 0.9, (under, total)


def test_replayed_forward_of_a_remat_block_adds_no_span():
    model, state, step, batch = _setup(remat="block")
    _, events = _profiled(lambda: step(state, batch))
    count = collections.Counter(e.name for e in _spans(events))
    for name in PER_LAYER:
        assert count[name] == count["bwd/" + name] == model.cfg.n_layers, (name, count)


def _grads(model, state, batch):
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    loss, (router, mets) = model.loss_fn(state.params, batch, state.router_states)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.detach() for g in grads], router


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bitwise(a, b):
    """Same dtype, shape and bits (so -0.0 and NaN payloads count)."""
    if not isinstance(a, torch.Tensor):
        return a == b
    bits = _BITS[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(bits), b.reshape(-1).view(bits))


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("remat", ["none", "block"])
def test_bitwise_equal_with_and_without_the_profiler(remat, compute_dtype):
    model, state, step, batch = _setup(remat=remat, compute_dtype=compute_dtype)
    off_state, on_state = copy.deepcopy(state), copy.deepcopy(state)

    loss_off, grads_off, router_off = _grads(model, off_state, batch)
    (loss_on, grads_on, router_on), _ = _profiled(lambda: _grads(model, on_state, batch))
    assert _bitwise(loss_off, loss_on)
    assert all(_bitwise(a, b) for a, b in zip(grads_off, grads_on))

    off_state, _ = step(off_state, batch)
    (on_state, mets_on), _ = _profiled(lambda: step(on_state, batch))
    for a, b in zip(tree_leaves(off_state.params), tree_leaves(on_state.params)):
        assert _bitwise(a.detach(), b.detach())
    for a, b in zip(tree_leaves(off_state.opt_state), tree_leaves(on_state.opt_state)):
        assert _bitwise(a, b)
    for so, sn in zip(off_state.router_states, on_state.router_states):
        assert so.keys() == sn.keys() and all(_bitwise(so[k], sn[k]) for k in so)


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    model, state, step, batch = _setup()
    calls = []
    enter = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: calls.append(a[0]) or enter(*a))

    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(state.params, batch, state.router_states)
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        assert not any(n in node.name() for n in ("_Enter", "_Exit", "_Cast")), node.name()
        todo.extend(f for f, _ in node.next_functions)
    assert len(seen) > 100
    with named_span("a"), trace_span("b"):
        w = torch.ones(3, requires_grad=True)
        assert layer_span("c", torch.mul, w, 2.0).grad_fn.name() == "MulBackward0"
        assert common.cast_weights(torch.bfloat16, w)[0].grad_fn.name() == "ToCopyBackward0"
    step(state, batch)
    assert calls == []

    # the same calls reach the patched entry point under a profiler
    _profiled(lambda: step(state, batch))
    assert "model/attention" in calls and "bwd/model/attention" in calls


def test_region_without_a_gradient_gets_no_twin():
    x = torch.ones(4)
    w = torch.ones(4, requires_grad=True)

    def run():
        y = layer_span("t/nograd", torch.mul, x, 2.0)
        with torch.no_grad():
            z = layer_span("t/nograd_mode", torch.mul, w, 2.0)
        u = layer_span("t/grad", torch.mul, w, 2.0)
        (u * y * z).sum().backward()

    _, events = _profiled(run)
    names = collections.Counter(e.name for e in _spans(events))
    assert names["t/nograd"] == names["t/nograd_mode"] == names["t/grad"] == names["bwd/t/grad"] == 1
    assert not names["bwd/t/nograd"] and not names["bwd/t/nograd_mode"]
