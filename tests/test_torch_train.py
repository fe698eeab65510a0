"""Port vs reference: the training slice — the aux_loss and lossfree
balancers, training attention, Model.forward/loss_fn, AdamW and the
schedules, BalanceTracker, the synthetic data, three train steps from one
converted TrainState, test perplexity, and the train CLI.

The model is reduced minimind-16e with the FULL routing table (16 experts,
top-4), fp32 compute, parameters from the reference's init carried over by
`repro_torch.convert`; data are the synthetic stream, drawn with numpy by
both packages. Tolerances, each with its reason:
  * forward/attention fp32: rtol/atol 1e-4 (as tests/test_torch_model.py:
    einsums and softmax sum in other orders);
  * AdamW: rtol 1e-6 on one update from identical inputs (fp32 arithmetic,
    other fusion);
  * three train steps, topk/aux_loss/lossfree: losses rtol 1e-5, grad norm
    rtol 1e-3 (Adam's first steps turn ulp-level gradient differences on
    near-zero entries into full-size parameter steps, which grow the
    difference by the third step), router states allclose at atol 1e-7 and
    per-layer MaxVio equal (the selections agree);
  * three train steps, bip on the K3 kernel path: BIP's capacity boundary
    is LP-degenerate (ROADMAP.md, queue 3), so ulp differences move a few
    capacity-marginal tokens to the other, equally optimal expert and the
    trajectories part slowly: losses rtol 1e-4, q atol 0.01 (~1/4 of a
    histogram bin at 512 bins), per-layer MaxVio within 0.1 (three tokens
    at this batch's mean load of 32).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import router as jax_router  # noqa: E402
from repro.core.metrics import BalanceTracker as JaxBalanceTracker  # noqa: E402
from repro.data import SyntheticBatchStream as JaxStream  # noqa: E402
from repro.data import make_batches as jax_make_batches  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_numpy,
    router_states_from_numpy,
    train_state_from_numpy,
)
from repro_torch.core import router  # noqa: E402
from repro_torch.core.metrics import BalanceTracker  # noqa: E402
from repro_torch.data import SyntheticBatchStream, make_batches  # noqa: E402
from repro_torch.models import Model, common  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.training import evaluate_ppl, make_train_step  # noqa: E402

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


# ------------------------------------------------------------- balancers


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("strategy", ["aux_loss", "lossfree"])
def test_balancer_route_matches_reference(strategy, masked, monkeypatch):
    """route() over 3 warm steps on bit-identical scores: state bit-equal,
    selection equal, aux loss allclose."""
    rc = jax_configs.get(ARCH).routing.to_router_config(strategy=strategy)
    tc = configs.get(ARCH).routing.to_router_config(strategy=strategy)
    monkeypatch.setattr(
        router, "compute_scores",
        lambda lg, cfg: _t(jax_router.compute_scores(jnp.asarray(lg.numpy()), rc)),
    )
    sj, st = {"q": jnp.zeros((16,), jnp.float32)}, {"q": torch.zeros(16)}
    rng = np.random.default_rng(3)
    for _ in range(3):
        logits = (rng.standard_normal((96, 16)) * 1.5 + np.linspace(-1, 1, 16)).astype(np.float32)
        mask = rng.random(96) < 0.7 if masked else None
        oj = jax_router.route(jnp.asarray(logits), sj, rc,
                              token_mask=None if mask is None else jnp.asarray(mask))
        ot = router.route(_t(logits), st, tc, token_mask=None if mask is None else _t(mask))
        np.testing.assert_array_equal(ot.state["q"].numpy(), np.asarray(oj.state["q"]))
        np.testing.assert_array_equal(ot.expert_index.numpy(), np.asarray(oj.expert_index))
        np.testing.assert_allclose(float(ot.aux_loss), float(oj.aux_loss), rtol=1e-6, atol=1e-9)
        sj, st = oj.state, ot.state


def test_aux_loss_carries_the_gradient():
    """aux_loss: the loss reaches the router scores (P_j), not the counts."""
    tc = configs.get(ARCH).routing.to_router_config(strategy="aux_loss")
    logits = torch.randn(32, 16, generator=torch.Generator().manual_seed(0), requires_grad=True)
    out = router.route(logits, {"q": torch.zeros(16)}, tc)
    assert float(out.aux_loss.detach()) > 0
    (g,) = torch.autograd.grad(out.aux_loss, logits)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# -------------------------------------------------------------- model


@pytest.mark.parametrize(
    "layer_kind,seq", [("global", 48), ("global", 40), ("local", 40)]
)
def test_training_attention_matches_reference(layer_kind, seq):
    """Chunked causal attention (attn_chunk 16, so seq 40 pads the last
    chunk), global and sliding-window layers."""
    kw = dict(attn_pattern=(layer_kind,), attn_chunk=16)
    if layer_kind == "local":
        kw["window_size"] = 12
    jcfg, tcfg = _cfgs("topk", False, **kw)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    attn_j = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"][0]["attn"])
    attn_t = {k: _t(v) for k, v in jax.device_get(attn_j).items()}
    x = np.random.default_rng(0).standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    yj = jax_common.attention(attn_j, jnp.asarray(x), jcfg, layer_kind=layer_kind)
    yt = common.attention(attn_t, _t(x), tcfg, layer_kind=layer_kind)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strategy", ["topk", "aux_loss"])
def test_forward_and_loss_match_reference(strategy):
    """Model.forward/loss_fn from one set of params: logits, CE, aux loss,
    perplexity and the per-layer metric columns."""
    jm, tm = _models(strategy)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), tm.cfg, "cpu")
    batch_j = next(iter(jax_make_batches(jm.cfg, 3, 24, 1)))
    batch_j["labels"] = batch_j["labels"].at[0, :5].set(-1)  # masked labels
    batch_t = {k: _t(v).long() for k, v in batch_j.items()}
    lj, _, _, _ = jm.forward(jp, batch_j, jm.init_router_states())
    lt, _, _, _ = tm.forward(tp, batch_t, tm.init_router_states())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    loss_j, (sj, mj) = jm.loss_fn(jp, batch_j, jm.init_router_states())
    with torch.no_grad():
        loss_t, (st, mt) = tm.loss_fn(tp, batch_t, tm.init_router_states())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for k in ("ce_loss", "aux_loss", "perplexity"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, atol=1e-8)
    assert set(mt) >= {"max_vio_per_layer", "load_per_layer", "q_abs_max_per_layer"}
    np.testing.assert_array_equal(mt["load_per_layer"].numpy(), np.asarray(mj["load_per_layer"]))
    np.testing.assert_allclose(mt["max_vio_per_layer"].numpy(), np.asarray(mj["max_vio_per_layer"]))
    assert len(st) == tm.cfg.n_layers


# ---------------------------------------------------------- optimizer


def test_adamw_update_matches_reference():
    """Two AdamW steps with clipping (the grads' norm exceeds clip_norm) on
    a matrix (decayed) and a vector (not decayed)."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 2).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    jcfg, tcfg = jax_adamw.AdamWConfig(), adamw.AdamWConfig()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_adamw.adamw_init(jp, jcfg)
    tp = {k: _t(v) for k, v in params.items()}
    ts = adamw.adamw_init(tp, tcfg)
    for g in grads:
        jp, js, jinfo = jax_adamw.adamw_update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                                               jnp.float32(1e-2), jcfg)
        tp, ts, tinfo = adamw.adamw_update([_t(g[k]) for k in tp], ts, tp, 1e-2, tcfg)
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js["mu"][k]), rtol=1e-6)
            np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js["nu"][k]), rtol=1e-6)
    assert ts["step"] == int(js["step"]) == 2


def test_schedules_match_reference():
    for name, args in (("constant", (0.5,)), ("cosine_schedule", (1.0, 50)),
                       ("linear_warmup_cosine", (3e-4, 10, 100))):
        fj, ft = getattr(jax_schedules, name)(*args), getattr(schedules, name)(*args)
        for step in (0, 1, 5, 10, 11, 57, 100, 130):
            np.testing.assert_allclose(ft(step), float(fj(jnp.float32(step))), rtol=1e-6)


def test_balance_tracker_matches_reference():
    jt, tt = JaxBalanceTracker(), BalanceTracker()
    assert tt.summary() == jt.summary() == {"AvgMaxVio": 0.0, "SupMaxVio": 0.0}
    for v in (0.5, 0.125, 1.25):
        jt.add(v)
        tt.add(torch.tensor(v))
    assert tt.summary() == jt.summary()


# --------------------------------------------------------------- data


def test_synthetic_batches_are_bit_equal():
    jcfg, tcfg = _cfgs()
    for split in ("train", "test"):
        for bj, bt in zip(jax_make_batches(jcfg, 3, 17, 3, seed=2, split=split),
                          make_batches(tcfg, 3, 17, 3, seed=2, split=split)):
            for k in ("tokens", "labels"):
                assert bt[k].dtype == torch.int64
                np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    sj, st = JaxStream(jcfg, 2, 9, 5), SyntheticBatchStream(tcfg, 2, 9, 5)
    sj.load_state_dict({"step": 3})
    st.load_state_dict({"step": 3})
    rest_j, rest_t = list(sj), list(st)
    assert len(rest_t) == len(rest_j) == 2 and st.state_dict() == sj.state_dict()
    for bj, bt in zip(rest_j, rest_t):
        np.testing.assert_array_equal(bt["tokens"].numpy(), np.asarray(bj["tokens"]))


# ------------------------------------------------------------ training


def _three_steps(strategy, use_kernel):
    """3 train steps of both packages from one TrainState (the reference's
    init, converted) on the same synthetic batches. Yields, per step, the
    reference's and the port's metrics and router states."""
    jm, tm = _models(strategy, use_kernel)
    jopt = jax_adamw.from_model_config(jm.cfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jopt)
    ts = train_state_from_numpy(
        jax.device_get(js.params), jax.device_get(js.opt_state),
        jax.device_get(js.router_states), tm.cfg, "cpu",
    )
    jstep = jax.jit(jax_loop.make_train_step(
        jm, jopt, jax_schedules.linear_warmup_cosine(1e-3, 1, 10)))
    tstep = make_train_step(
        tm, adamw.from_model_config(tm.cfg), schedules.linear_warmup_cosine(1e-3, 1, 10))
    for bj, bt in zip(jax_make_batches(jm.cfg, 4, 32, 3), make_batches(tm.cfg, 4, 32, 3)):
        js, mj = jstep(js, bj)
        ts, mt = tstep(ts, bt)
        qj = np.stack([s["q"].numpy() for s in
                       router_states_from_numpy(jax.device_get(js.router_states), tm.cfg)])
        qt = np.stack([s["q"].numpy() for s in ts.router_states])
        yield mj, mt, qj, qt
    assert ts.opt_state["step"] == 3


@pytest.mark.parametrize("strategy", ["topk", "aux_loss", "lossfree"])
def test_three_train_steps_match_reference(strategy):
    for mj, mt, qj, qt in _three_steps(strategy, use_kernel=False):
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(qt, qj, atol=1e-7)
        np.testing.assert_array_equal(
            mt["max_vio_per_layer"].numpy(), np.asarray(mj["max_vio_per_layer"]))


def test_three_train_steps_bip_kernel_path_within_bounds():
    """use_kernel=True: the K3 dual update (plain version on the CPU) and the
    K1/K2 expert FFN with its custom backward, against the reference's
    Pallas path in interpret mode."""
    for mj, mt, qj, qt in _three_steps("bip", use_kernel=True):
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
        np.testing.assert_allclose(qt, qj, atol=0.01)
        np.testing.assert_allclose(
            mt["max_vio_per_layer"].numpy(), np.asarray(mj["max_vio_per_layer"]), atol=0.1)
        assert float(mt["max_vio_per_layer"].max()) < 0.5  # balanced, as BIP promises


def test_evaluate_ppl_matches_reference():
    jm, tm = _models("topk")
    jopt = jax_adamw.from_model_config(jm.cfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jopt)
    ts = train_state_from_numpy(
        jax.device_get(js.params), jax.device_get(js.opt_state),
        jax.device_get(js.router_states), tm.cfg, "cpu",
    )
    pj = jax_loop.evaluate_ppl(jm, js, jax_make_batches(jm.cfg, 2, 16, 2, split="test"))
    pt = evaluate_ppl(tm, ts, make_batches(tm.cfg, 2, 16, 2, split="test"))
    np.testing.assert_allclose(pt, pj, rtol=1e-5)


def test_train_step_refuses_what_is_not_ported():
    tm = Model(_cfgs()[1], device="cpu")
    opt = adamw.from_model_config(tm.cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(tm, opt, schedules.constant(1e-3), microbatches=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(tm, opt, schedules.constant(1e-3), guarded=True)


def test_train_cli_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train

    out_json = tmp_path / "summary.json"
    rc = train.main([
        "--arch", "minimind-moe-16e", "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq-len", "16", "--log-every", "1", "--out-json", str(out_json),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "method=bip" in out and "step     1 loss" in out
    summary = json.loads(out_json.read_text())
    assert len(summary["losses"]) == 2 and all(np.isfinite(summary["losses"]))
    for key in ("AvgMaxVio", "SupMaxVio", "AvgMaxVio_per_layer", "step_time_p50", "test_ppl"):
        assert key in summary
    assert np.isfinite(summary["test_ppl"]) and summary["test_ppl"] > 1.0
