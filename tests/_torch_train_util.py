"""Shared helpers of the port's training parity tests
(tests/test_torch_train.py, tests/test_torch_train_text.py,
tests/test_torch_balancers.py): the reduced minimind-16e configs of both
packages, and three train steps of both from one converted TrainState.
Not collected by pytest (no test_ prefix)."""
from __future__ import annotations

import dataclasses

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
from repro_torch.convert import (  # noqa: E402
    params_from_numpy,
    router_states_from_numpy,
    train_state_from_numpy,
)
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

ARCH = "minimind_moe_16e"


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(strategy="bip", use_kernel=True, **kw):
    jfull, tfull = jax_configs.get(ARCH), configs.get(ARCH)
    jr = dataclasses.replace(jfull.routing, strategy=strategy, use_kernel=use_kernel)
    tr = dataclasses.replace(tfull.routing, strategy=strategy, use_kernel=use_kernel)
    return (
        jax_configs.reduced_for_smoke(ARCH, routing=jr, vocab_size=128, **kw),
        configs.reduced_for_smoke(ARCH, routing=tr, vocab_size=128, **kw),
    )


def _models(strategy, use_kernel=False):
    jcfg, tcfg = _cfgs(strategy, use_kernel)
    jm = jax_build_model(jcfg)
    return jm, Model(tcfg, device="cpu")


def _three_steps(strategy, use_kernel, microbatches=1, batch=4, end=None):
    """3 train steps of both packages from one TrainState (the reference's
    init, converted) on the same synthetic batches. Yields, per step, the
    reference's and the port's metrics and router states; a list `end`
    receives the max |port - reference| of every param after the third
    step, by leaf path (the reference's stacks unstacked first)."""
    jm, tm = _models(strategy, use_kernel)
    jopt = jax_adamw.from_model_config(jm.cfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jopt)
    ts = train_state_from_numpy(
        jax.device_get(js.params), jax.device_get(js.opt_state),
        jax.device_get(js.router_states), tm.cfg, "cpu",
    )
    jstep = jax.jit(jax_loop.make_train_step(
        jm, jopt, jax_schedules.linear_warmup_cosine(1e-3, 1, 10), microbatches=microbatches))
    tstep = make_train_step(
        tm, adamw.from_model_config(tm.cfg), schedules.linear_warmup_cosine(1e-3, 1, 10),
        microbatches=microbatches)
    for bj, bt in zip(jax_make_batches(jm.cfg, batch, 32, 3), make_batches(tm.cfg, batch, 32, 3)):
        js, mj = jstep(js, bj)
        ts, mt = tstep(ts, bt)
        qj = np.stack([s["q"].numpy() for s in
                       router_states_from_numpy(jax.device_get(js.router_states), tm.cfg)])
        qt = np.stack([s["q"].numpy() for s in ts.router_states])
        yield mj, mt, qj, qt
    assert ts.opt_state["step"] == 3
    if end is not None:
        ref = dict(adamw.tree_paths(params_from_numpy(jax.device_get(js.params), tm.cfg, "cpu")))
        end.append({path: float((p.detach() - ref[path]).abs().max())
                    for path, p in adamw.tree_paths(ts.params)})
