"""Port vs reference: the training slice — the aux_loss and lossfree
balancers, training attention, Model.forward/loss_fn, AdamW (with the
reference's weight-decay mask over its stacked layout) and the schedules,
BalanceTracker, the synthetic data, three train steps from one converted
TrainState and test perplexity. The longer loops (the train CLI, segments,
microbatches, the guarded step, rollback, resume) are in
tests/test_torch_train_text.py; the shared helpers in
tests/_torch_train_util.py.

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
    per-layer MaxVio equal (the selections agree); after the third step
    every param within 1e-5 and every norm scale within 1e-6 (the level
    at which final_norm, decayed by neither package, agrees);
  * three train steps, bip on the K3 kernel path: BIP's capacity boundary
    is LP-degenerate (ROADMAP.md, queue 3), so ulp differences move a few
    capacity-marginal tokens to the other, equally optimal expert and the
    trajectories part slowly: losses rtol 1e-4, q atol 0.01 (~1/4 of a
    histogram bin at 512 bins), per-layer MaxVio within 0.1 (three tokens
    at this batch's mean load of 32);
  * microbatched steps: the same contracts per strategy, on the loss (the
    mean over microbatches), the grad norm, the router states and the
    reduced metrics (MaxVio by max, load by sum: equal for top-k/aux_loss/
    lossfree, within the bounds above for bip);
  * the port against itself (guarded vs unguarded, NaN skip, rollback,
    resume): bit-equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from _torch_train_util import ARCH, _cfgs, _models, _t, _three_steps

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
from repro_torch.convert import decay_mask, params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.core import router  # noqa: E402
from repro_torch.core.metrics import BalanceTracker  # noqa: E402
from repro_torch.data import SyntheticBatchStream, make_batches  # noqa: E402
from repro_torch.models import Model, common  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.training import (  # noqa: E402
    evaluate_ppl,
    init_train_state,
    make_train_step,
)


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
    a matrix (decayed), a vector (not decayed) and a per-layer vector of
    the stack, which the reference holds as one (G, d) stack and so decays:
    the port's (d,) per-layer leaves must be decayed too."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "scale": (1.0 + 0.1 * rng.standard_normal((2, 5))).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 2).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]

    def ref_tree(t):  # the reference's layout: the per-layer scales stacked
        return {"w": jnp.asarray(t["w"]), "b": jnp.asarray(t["b"]),
                "stack": {"blocks": [{"scale": jnp.asarray(t["scale"])}]}}

    def port_tree(t):  # the port's: one dict per layer
        return {"w": _t(t["w"]), "b": _t(t["b"]),
                "stack": {"layers": [{"scale": _t(t["scale"][i])} for i in range(2)]}}

    jcfg, tcfg = jax_adamw.AdamWConfig(), adamw.AdamWConfig()
    jp = ref_tree(params)
    js = jax_adamw.adamw_init(jp, jcfg)
    tp = port_tree(params)
    ts = adamw.adamw_init(tp, tcfg)
    assert decay_mask(tp) == {"b": False, "stack.layers[0].scale": True,
                              "stack.layers[1].scale": True, "w": True}
    for g in grads:
        jp, js, jinfo = jax_adamw.adamw_update(ref_tree(g), js, jp, jnp.float32(1e-2), jcfg)
        tp, ts, tinfo = adamw.adamw_update(adamw.tree_leaves(port_tree(g)), ts, tp, 1e-2, tcfg,
                                           decay_mask(tp))
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]), rtol=1e-6)
        for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
            for k in ("w", "b"):
                np.testing.assert_allclose(tree_t[k].numpy(), np.asarray(tree_j[k]), rtol=1e-6, atol=1e-7)
            stacked = np.stack([layer["scale"].numpy() for layer in tree_t["stack"]["layers"]])
            np.testing.assert_allclose(stacked, np.asarray(tree_j["stack"]["blocks"][0]["scale"]),
                                       rtol=1e-6, atol=1e-7)
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


@pytest.mark.parametrize("strategy", ["topk", "aux_loss", "lossfree"])
def test_three_train_steps_match_reference(strategy):
    end = []
    for mj, mt, qj, qt in _three_steps(strategy, use_kernel=False, end=end):
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(qt, qj, atol=1e-7)
        np.testing.assert_array_equal(
            mt["max_vio_per_layer"].numpy(), np.asarray(mj["max_vio_per_layer"]))
    # every param after the three steps, the per-layer norm scales too:
    # weight decay reaches the leaves the reference decays in its stacks
    (diffs,) = end
    assert max(diffs.values()) <= 1e-5, diffs
    norms = {k: v for k, v in diffs.items() if k.endswith("norm.scale")}
    assert len(norms) == 5 and max(norms.values()) <= 1e-6, norms


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


def test_train_step_refuses_what_is_not_ported(tmp_path):
    """Microbatches, the guarded step, telemetry, the profiler window, the
    router-dual watchdog and the forecaster are ported; what is still
    refused: a batch that does not split into the microbatches
    (ValueError), the reference launcher's TPU-pod flags, which the port's
    launcher does not accept, and --mesh (tests/test_torch_train_mesh.py,
    tests/test_torch_mesh_ckpt.py) with a malformed shape or outside
    torch.distributed.run, with or without checkpoints and microbatches."""
    tm = Model(_cfgs()[1], device="cpu")
    opt = adamw.from_model_config(tm.cfg)
    step = make_train_step(tm, opt, schedules.constant(1e-3), microbatches=2)
    batch = next(iter(make_batches(tm.cfg, 3, 8, 1)))
    with pytest.raises(ValueError, match="microbatches"):
        step(init_train_state(tm, 0, opt), batch)
    for routing in ({"guard_duals": True}, {"forecast": True, "sync": "global", "use_kernel": False}):
        cfg = dataclasses.replace(tm.cfg, routing=dataclasses.replace(tm.cfg.routing, **routing))
        model = Model(cfg, device="cpu")
        _, mets = make_train_step(model, opt, schedules.constant(1e-3))(
            init_train_state(model, 0, opt), next(iter(make_batches(cfg, 2, 8, 1))))
        assert np.isfinite(float(mets["loss"]))
    from repro_torch.launch import train

    base = ["--arch", "minimind-moe-16e", "--reduced", "--device", "cpu", "--steps", "1"]
    for flags in (["--production"], ["--multi-pod"], ["--coordinator", "h:1"], ["--num-hosts", "2"],
                  ["--host-id", "1"], ["--mesh", "2x1"], ["--mesh", "2x1", "--micro", "2"],
                  ["--mesh", "2x1", "--ckpt-dir", str(tmp_path / "ck")], ["--mesh", "2by1"]):
        with pytest.raises(SystemExit):
            train.main(base + flags)