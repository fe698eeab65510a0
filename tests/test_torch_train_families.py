"""Port vs reference: training the ten other architectures (the encoder's
unused cross leaves, block rematerialisation, mamba's backward through the
chunked SSD, the train CLI's new --arch values).

Every model runs at the reference's `reduced_for_smoke` size with fp32
compute. Parameters and Adam moments come from the reference's
`init_train_state` through `convert.train_state_from_numpy`; both packages
train on the synthetic stream, drawn with numpy (batch 2 x 16, frames and
patches from the seeded stubs). The reference's train step is jitted once
per configuration (module-level cache), so the file stays light.

Tolerances, each with its reason:
  * three train steps against the reference: losses rtol 1e-5, and after
    them every param within 1e-5 (abs) of the reference's, the bound of
    the minimind three-step test (tests/test_torch_train.py). Gradients
    agree to rtol 1e-4 / atol 1e-5 (tests/test_torch_families.py: fp32
    sums in other orders), and Adam's first steps can turn such
    differences on near-zero gradient entries into larger parameter
    steps; the largest seen is 1.04e-6 (zamba2's embedding). The
    encoder's cross leaves get no gradient in either package and are
    decayed alike: within 1e-7 (1.5e-8 seen).
  * remat="block" against remat="none" in the port: the loss and the
    router states bitwise (the recomputation replays the same operations
    in the same order), the gradients within 1e-6 (abs).
  * the port's remat step against the reference's remat step: the same
    bound as the three steps above.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jax_configs  # noqa: E402
from repro.data import make_batches as jax_make_batches  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.kernels import adamw_step  # noqa: E402
from repro_torch.models import Model, stack  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402
from repro_torch.training.loop import unused_leaves  # noqa: E402

B, S, STEPS = 2, 16, 3
PARAM_ATOL = 1e-5
CROSS_ATOL = 1e-7
REMAT_GRAD_ATOL = 1e-6
# (arch, overrides of reduced_for_smoke): zamba2 at one shared-block period
ZAMBA_ONE_PERIOD = ("zamba2_7b", (("n_layers", 2),))
SEAMLESS, MAMBA = ("seamless_m4t_large_v2", ()), ("mamba2_130m", ())


def _lr():
    return 1e-3, 1, 10  # peak lr, warmup, total steps of linear_warmup_cosine


@functools.lru_cache(maxsize=None)
def _three_steps(arch, overrides, remat="none"):
    """Three train steps of both packages from one TrainState (the
    reference's init, converted) on the same batches. Returns ({path: max
    |port - reference|} of every param after them, the paths without a
    gradient in the port, the port's and the reference's losses)."""
    kw = dict(overrides, remat=remat)
    jm = jax_build_model(jax_configs.reduced_for_smoke(arch, **kw))
    tm = Model(configs.reduced_for_smoke(arch, **kw), device="cpu")
    jopt = jax_adamw.from_model_config(jm.cfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jopt)
    ts = train_state_from_numpy(jax.device_get(js.params), jax.device_get(js.opt_state),
                                jax.device_get(js.router_states), tm.cfg, "cpu")
    jstep = jax.jit(jax_loop.make_train_step(jm, jopt, jax_schedules.linear_warmup_cosine(*_lr())))
    tstep = make_train_step(tm, adamw.from_model_config(tm.cfg), schedules.linear_warmup_cosine(*_lr()))
    losses = []
    for bj, bt in zip(jax_make_batches(jm.cfg, B, S, STEPS), make_batches(tm.cfg, B, S, STEPS)):
        js, mj = jstep(js, bj)
        ts, mt = tstep(ts, bt)
        losses.append((float(mt["loss"]), float(mj["loss"])))
    assert ts.opt_state["step"] == STEPS
    ref = dict(adamw.tree_paths(params_from_numpy(jax.device_get(js.params), tm.cfg, "cpu")))
    diffs = {path: float((p.detach() - ref[path]).abs().max()) for path, p in adamw.tree_paths(ts.params)}
    return diffs, unused_leaves(tm.cfg, ts.params), losses


def _check_three_steps(arch, overrides, remat="none"):
    diffs, unused, losses = _three_steps(arch, overrides, remat)
    for lt, lj in losses:
        assert math.isfinite(lt)
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= PARAM_ATOL, f"{worst}: {diffs[worst]:.3e}"
    return diffs, unused


def test_seamless_three_steps_match_reference():
    """(a) encdec: every param after three steps, the encoder's unused
    cross leaves (zero gradients, decayed by AdamW) included."""
    diffs, unused = _check_three_steps(*SEAMLESS)
    n_enc = configs.reduced_for_smoke(SEAMLESS[0]).n_enc_layers
    assert unused and len(unused) == n_enc * 5  # cross_norm.scale + cross.{wq,wk,wv,wo} per layer
    assert all(p.startswith("encoder.layers[") and ".cross" in p for p in unused)
    assert max(diffs[p] for p in unused) <= CROSS_ATOL


@pytest.mark.parametrize("arch,overrides", [MAMBA, ZAMBA_ONE_PERIOD], ids=["mamba2_130m", "zamba2_one_period"])
def test_mamba_stacks_three_steps_match_reference(arch, overrides):
    """(b) mamba's backward through ssd_chunked, and the shared block."""
    _, unused = _check_three_steps(arch, overrides)
    assert unused == set()


@pytest.mark.parametrize("arch,overrides", [ZAMBA_ONE_PERIOD, SEAMLESS], ids=["zamba2_one_period", "seamless"])
def test_remat_step_matches_reference_remat_step(arch, overrides):
    """(e) the port's remat='block' steps against the reference's
    jax.checkpoint steps: the stack's period and the encoder's layers."""
    _check_three_steps(arch, overrides, remat="block")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_one_step_of_every_reduced_config(arch):
    """One step of every configuration through make_train_step: a finite
    loss, finite params after it, and no leaf without a gradient but the
    encoder's cross leaves (encdec only)."""
    cfg = configs.reduced_for_smoke(arch)
    model = Model(cfg, device="cpu")
    opt = adamw.from_model_config(cfg)
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt, schedules.linear_warmup_cosine(*_lr()))
    state, mets = step(state, next(make_batches(cfg, B, S, 1)))
    assert math.isfinite(float(mets["loss"])) and math.isfinite(float(mets["grad_norm"]))
    assert all(bool(torch.isfinite(p).all()) for p in adamw.tree_leaves(state.params))
    assert bool(unused_leaves(cfg, state.params)) == (cfg.family == "encdec")


def test_unused_leaf_outside_the_encoder_cross_raises(monkeypatch):
    """(c) on minimind, a leaf cut from the graph (the shared expert, by
    dropping the residual MLPs) raises, naming its path."""
    cfg = configs.reduced_for_smoke("minimind_moe_16e")
    model = Model(cfg, device="cpu")
    opt = adamw.from_model_config(cfg)
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt, schedules.linear_warmup_cosine(*_lr()))
    monkeypatch.setattr(stack, "_residual_mlps", lambda p, xin, cfg: 0)
    with pytest.raises(RuntimeError, match=r"stack\.layers\[0\]\.shared_mlp\.w_down"):
        step(state, next(make_batches(cfg, B, S, 1)))


def test_unknown_remat_value_is_refused():
    """A remat value other than 'none' or 'block' would train without
    rematerialisation, the fault this slice repaired: the config refuses it."""
    with pytest.raises(ValueError, match="remat"):
        Model(dataclasses.replace(configs.reduced_for_smoke("mamba2_130m"), remat="blocks"), device="cpu")


def _grads_of(cfg, params, batch):
    model = Model(cfg, device="cpu")
    leaves = adamw.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, (states, _) = model.loss_fn(params, batch, model.init_router_states())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return loss.detach(), states, grads


def _minimind(strategy):
    full = configs.get("minimind_moe_16e").routing
    return "minimind_moe_16e", dict(
        routing=dataclasses.replace(full, strategy=strategy, use_kernel=False), vocab_size=128)


@pytest.mark.parametrize("case", ["minimind_bip", "minimind_lossfree", "zamba2", "seamless"])
def test_remat_block_matches_none(case):
    """(d) remat='block' against remat='none' in the port on the same
    params and batch: loss and router states bitwise, gradients within
    REMAT_GRAD_ATOL; minimind routes with the full 16-expert table (bip on
    the plain exact dual, and lossfree), zamba2 checkpoints periods of two
    layers around the shared block, seamless its encoder layers."""
    arch, kw = {"minimind_bip": _minimind("bip"), "minimind_lossfree": _minimind("lossfree"),
                "zamba2": ("zamba2_7b", {}), "seamless": ("seamless_m4t_large_v2", {})}[case]
    base = configs.reduced_for_smoke(arch, **kw)
    params = Model(base, device="cpu").init(0)
    batch = next(make_batches(base, 4, 24, 1))
    out = {remat: _grads_of(dataclasses.replace(base, remat=remat), params, batch)
           for remat in ("none", "block")}
    (l0, s0, g0), (l1, s1, g1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    for a, b in zip(s0, s1):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=REMAT_GRAD_ATOL)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "zamba2-7b"])
def test_train_cli_trains_the_family_on_cpu(arch, tmp_path, capsys):
    """(f) the train CLI on the CPU: every step's loss finite."""
    from repro_torch.launch import train as launch_train

    out = tmp_path / "summary.json"
    assert launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                              "--batch", "2", "--seq-len", "16", "--log-every", "1",
                              "--out-json", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert len(summary["losses"]) == 2 and all(math.isfinite(v) for v in summary["losses"])
    assert math.isfinite(summary["test_ppl"])


@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_adamw_slices_are_bitwise_the_whole_update(moments, monkeypatch):
    """AdamW's plain version (the CPU path) updates a leaf in slices of
    adamw_step._SLICE elements to bound its fp32 temporaries at full width (llama4-scout's 1e9-element embedding);
    three guarded steps in slices of 1000 elements are bitwise those in one
    slice, params and both moments, with and without weight decay."""
    dt = torch.float32 if moments == "fp32" else torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    base = {"w": torch.randn(300, 77, generator=gen).to(dt), "v": torch.randn(1000, generator=gen).to(dt)}
    grads = [torch.randn(p.shape, generator=gen).to(dt) for p in adamw.tree_leaves(base)]
    cfg = adamw.AdamWConfig(mu_dtype=dt, nu_dtype=dt)
    runs = []
    for size in (1 << 26, 1000):
        monkeypatch.setattr(adamw_step, "_SLICE", size)
        params = adamw.tree_map(torch.clone, base)
        opt = adamw.adamw_init(params, cfg)
        for _ in range(3):
            adamw.adamw_update(list(grads), opt, params, 1e-3, cfg, decay={"v": False, "w": True},
                               guard=torch.tensor(True))
            opt["step"] += 1
        runs.append(adamw.tree_leaves([params, opt["mu"], opt["nu"]]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
