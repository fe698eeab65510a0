"""Port vs reference: the training slice — the aux_loss and lossfree
balancers, training attention (with and without document segments),
Model.forward/loss_fn, AdamW and the schedules, BalanceTracker, the
synthetic data, three train steps from one converted TrainState (one and
two microbatches), the guarded step and the guard ladder in train_loop,
test perplexity, and the train CLI (synthetic, and real text with a
checkpoint and a bit-exact resume).

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
import json
import os
import signal

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
from repro_torch.robustness import FaultPlan, GuardConfig  # noqa: E402
from repro_torch.training import (  # noqa: E402
    evaluate_ppl,
    init_train_state,
    make_train_step,
    train_loop,
)

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
        tp, ts, tinfo = adamw.adamw_update([_t(g[k]) for k in sorted(tp)], ts, tp, 1e-2, tcfg)
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


def _three_steps(strategy, use_kernel, microbatches=1, batch=4):
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


def test_train_step_refuses_what_is_not_ported(tmp_path):
    """Microbatches and the guarded step are ported; what is still refused:
    a batch that does not split into the microbatches (ValueError), and the
    deferrals of ROADMAP.md queue 1 (telemetry, the profiler window, the
    router-dual watchdog in training, the forecaster windows), each loudly."""
    tm = Model(_cfgs()[1], device="cpu")
    opt = adamw.from_model_config(tm.cfg)
    step = make_train_step(tm, opt, schedules.constant(1e-3), microbatches=2)
    batch = next(iter(make_batches(tm.cfg, 3, 8, 1)))
    with pytest.raises(ValueError, match="microbatches"):
        step(init_train_state(tm, 0, opt), batch)
    for routing in ({"guard_duals": True}, {"forecast": True}):
        cfg = dataclasses.replace(tm.cfg, routing=dataclasses.replace(tm.cfg.routing, **routing))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(Model(cfg, device="cpu"), opt, schedules.constant(1e-3))
    from repro_torch.launch import train

    base = ["--arch", "minimind-moe-16e", "--reduced", "--device", "cpu", "--steps", "1"]
    for flags in (["--telemetry", str(tmp_path / "t.jsonl")], ["--profile", "1:2"],
                  ["--guard-duals"], ["--forecast"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train.main(base + flags)


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


def test_train_cli_real_text_resume_is_bit_exact(tmp_path):
    """The real-text CLI: 4 steps with a checkpoint every 2 (pack_nocross,
    two microbatches), then --steps 6 --resume: steps 4-5 equal those of an
    uninterrupted 6-step run bit for bit, and the summary carries
    train_corpus_ppl."""
    from repro_torch.launch import train

    corpus = os.path.join(os.path.dirname(__file__), "fixtures", "corpus")
    base = ["--arch", "minimind-moe-16e", "--reduced", "--device", "cpu", "--data", corpus,
            "--pack-mode", "pack_nocross", "--micro", "2", "--batch", "4", "--seq-len", "32",
            "--log-every", "0"]

    def run(name, *flags):
        out = tmp_path / f"{name}.json"
        assert train.main(base + ["--out-json", str(out), *flags]) == 0
        return json.loads(out.read_text())

    full = run("full", "--steps", "6")
    ck = str(tmp_path / "ck")
    first = run("first", "--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2")
    resumed = run("resumed", "--steps", "6", "--ckpt-dir", ck, "--resume")
    assert first["losses"] == full["losses"][:4]
    assert resumed["losses"] == full["losses"][4:]
    assert sorted(os.listdir(ck)) == sorted(
        [f"step_{s}.{x}" for s in (2, 4, 6) for x in ("npz", "manifest.json", "data.json")]
        + ["tokenizer.json"])
    assert full["microbatches"] == 2 and full["pack_mode"] == "pack_nocross"
    assert np.isfinite(full["train_corpus_ppl"]) and full["train_corpus_ppl"] > 1.0
    assert resumed["train_corpus_ppl"] == full["train_corpus_ppl"]


# ------------------------------------------------------------ segments


def _packed_batch(vocab, b, s, seed=0):
    """A pack_nocross-shaped batch, drawn with numpy: three documents per
    row at random cuts, labels across a cut masked (-1), segments from 0."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1))
    seg = np.sort(rng.integers(0, 3, (b, s + 1)), axis=1)
    seg = seg - seg[:, :1]
    labels = np.where(seg[:, 1:] == seg[:, :-1], toks[:, 1:], -1)
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": labels.astype(np.int32),
            "segments": seg[:, :-1].astype(np.int32)}


@pytest.mark.parametrize("seq", [48, 40])
def test_forward_with_segments_matches_reference(seq):
    """Model.forward/loss_fn on a packed batch: logits rtol/atol 1e-4 (the
    forward's contract); attn_chunk 16, so seq 40 pads the last chunk's
    query rows, which take segment -2 and must not turn into NaN."""
    jcfg, tcfg = _cfgs("topk", False, attn_chunk=16)
    jm, tm = jax_build_model(jcfg), Model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), tm.cfg, "cpu")
    batch = _packed_batch(tcfg.vocab_size, 3, seq)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: _t(v).long() for k, v in batch.items()}
    lj, _, _, _ = jm.forward(jp, bj, jm.init_router_states())
    with torch.no_grad():
        lt, _, _, _ = tm.forward(tp, bt, tm.init_router_states())
        loss_t, _ = tm.loss_fn(tp, bt, tm.init_router_states())
    assert bool(torch.isfinite(lt).all())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    loss_j, _ = jm.loss_fn(jp, bj, jm.init_router_states())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


def test_segment_mask_isolates_documents():
    """The reference's per-document property, exact: with segments, changing
    one document moves no logit of the other (a dense trunk: MoE expert
    capacity is contested across the batch by design, so only attention is
    cut); without segments, causal attention carries doc 0 into doc 1."""
    from repro_torch.configs import RoutingSpec

    _, tcfg = _cfgs("topk", False)
    cfg = dataclasses.replace(tcfg, family="dense", routing=RoutingSpec())
    model = Model(cfg, device="cpu")
    params = model.init(0)
    rs = model.init_router_states()
    s, cut = 24, 10
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, s)))
    seg = torch.zeros((1, s), dtype=torch.int64)
    seg[:, cut:] = 1

    def logits(t, segments=True):
        batch = {"tokens": t, "labels": t}
        if segments:
            batch["segments"] = seg
        with torch.no_grad():
            return model.forward(params, batch, rs)[0]

    base = logits(toks)
    doc1_changed, doc0_changed = toks.clone(), toks.clone()
    doc1_changed[:, cut:] = (doc1_changed[:, cut:] + 7) % cfg.vocab_size
    doc0_changed[:, :cut] = (doc0_changed[:, :cut] + 7) % cfg.vocab_size
    assert torch.equal(logits(doc1_changed)[0, :cut], base[0, :cut])
    assert torch.equal(logits(doc0_changed)[0, cut:], base[0, cut:])
    assert not torch.equal(logits(doc0_changed, segments=False)[0, cut:],
                           logits(toks, segments=False)[0, cut:])


def test_backward_is_reproducible_on_the_cpu():
    """Two forward/backward passes from one state give bit-equal gradients
    (the row gathers' backward avoids the CPU's atomic adds), which the
    bit-exact resume and rollback tests rely on."""
    tm = Model(_cfgs("bip", True)[1], device="cpu")
    params = tm.init(0)
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = next(iter(make_batches(tm.cfg, 4, 32, 1)))
    grads = []
    for _ in range(2):
        loss, _ = tm.loss_fn(params, batch, tm.init_router_states())
        grads.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# -------------------------------------------------------- microbatches


@pytest.mark.parametrize("strategy", ["topk", "aux_loss", "lossfree"])
def test_microbatched_steps_match_reference(strategy):
    """microbatches=2: q carried between the two microbatches, gradients
    summed and halved, metrics reduced as the reference's
    _reduce_micro_mets (MaxVio max, load sum, perplexity from the mean CE)."""
    for mj, mt, qj, qt in _three_steps(strategy, use_kernel=False, microbatches=2):
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(mt["ce_loss"]), float(mj["ce_loss"]), rtol=1e-5)
        assert float(mt["perplexity"]) == float(torch.exp(mt["ce_loss"]))  # from the mean CE
        np.testing.assert_allclose(qt, qj, atol=1e-7)
        np.testing.assert_array_equal(
            mt["max_vio_per_layer"].numpy(), np.asarray(mj["max_vio_per_layer"]))
        np.testing.assert_array_equal(mt["load_per_layer"].numpy(), np.asarray(mj["load_per_layer"]))
        assert int(mt["load_per_layer"].sum()) == 2 * 4 * 32 * 4  # layers x tokens x top-k


def test_microbatched_steps_bip_kernel_path_within_bounds():
    """Batch 8 in two microbatches: each dual update sees 128 tokens, as in
    the three-step test the bip bounds were set at. (At 64 tokens per
    update one capacity-marginal token routed to the other, equally
    optimal expert moves the third step's loss 1.8e-4 relative, with q
    3.5e-3 and MaxVio one token apart: the same LP degeneracy, larger per
    token.)"""
    for mj, mt, qj, qt in _three_steps("bip", use_kernel=True, microbatches=2, batch=8):
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
        np.testing.assert_allclose(qt, qj, atol=0.01)
        np.testing.assert_allclose(
            mt["max_vio_per_layer"].numpy(), np.asarray(mj["max_vio_per_layer"]), atol=0.1)
        np.testing.assert_array_equal(
            mt["load_per_layer"].numpy().sum(axis=1), np.asarray(mj["load_per_layer"]).sum(axis=1))


# ------------------------------------------------------ the guarded step


def _state_bits(state):
    """Every leaf of a TrainState as numpy (params, both moments, router
    states) plus the step counter."""
    leaves = adamw.tree_leaves([state.params, state.opt_state["mu"], state.opt_state["nu"],
                                state.router_states])
    return [t.detach().clone().numpy() for t in leaves], state.opt_state["step"]


def _assert_same_state(a, b):
    (la, sa), (lb, sb) = a, b
    assert sa == sb and len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _tiny(strategy="lossfree"):
    return Model(_cfgs(strategy, False)[1], device="cpu")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_nan_or_forced_skip_leaves_the_state_bitwise(microbatches):
    """The guarded step with a NaN injected (controls[0]) or a forced skip
    (controls[1]): params, both moments, the step and q are bit-identical to
    their values before the step; a healthy guarded step equals the
    unguarded one bit for bit."""
    tm = _tiny()
    opt = adamw.from_model_config(tm.cfg)
    lr = schedules.linear_warmup_cosine(1e-3, 1, 10)
    gstep = make_train_step(tm, opt, lr, microbatches=microbatches, guarded=True)
    step = make_train_step(tm, opt, lr, microbatches=microbatches)
    b0, b1, b2 = make_batches(tm.cfg, 4, 32, 3)
    ga, _ = gstep(init_train_state(tm, 0, opt), b0, (0.0, 0.0, 1.0))
    ua, _ = step(init_train_state(tm, 0, opt), b0)
    _assert_same_state(_state_bits(ga), _state_bits(ua))
    before = _state_bits(ga)
    for controls in ((1.0, 0.0, 1.0), (0.0, 1.0, 1.0)):
        ga, mets = gstep(ga, b1, controls)
        assert not bool(mets["step_ok"])
        _assert_same_state(_state_bits(ga), before)
    ga, mets = gstep(ga, b2, (0.0, 0.0, 1.0))
    assert bool(mets["step_ok"]) and ga.opt_state["step"] == 2


def _ref_model():
    return jax_build_model(_cfgs("lossfree", False)[0])


def test_guard_events_match_reference():
    """The same fault plan (NaN at steps 1-5 under 'skip': five skips, an LR
    drop at the fourth) through both train loops: the same (kind, step)
    events and losses within the train contract."""
    from repro.robustness import FaultPlan as JaxFaultPlan
    from repro.robustness import GuardConfig as JaxGuardConfig

    spec = ["nan_grad@step=1:6"]
    tm, jm = _tiny(), _ref_model()
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jax_adamw.from_model_config(jm.cfg))
    ts = train_state_from_numpy(jax.device_get(js.params), jax.device_get(js.opt_state),
                                jax.device_get(js.router_states), tm.cfg, "cpu")
    _, lt = train_loop(tm, SyntheticBatchStream(tm.cfg, 4, 32, 8), lr=1e-3, total_steps=8,
                       state=ts, guard=GuardConfig(policy="skip"),
                       faults=FaultPlan.from_specs(spec))
    _, lj = jax_loop.train_loop(jm, JaxStream(jm.cfg, 4, 32, 8), lr=1e-3, total_steps=8,
                                state=js, guard=JaxGuardConfig(policy="skip"),
                                faults=JaxFaultPlan.from_specs(spec))
    events = [(e["kind"], e["step"]) for e in lt.events]
    assert events == [(e["kind"], e["step"]) for e in lj.events]
    assert ("lr_drop", 4) in events and sum(k == "nonfinite" for k, _ in events) == 5
    np.testing.assert_allclose(lt.losses, lj.losses, rtol=1e-5)


def test_guarded_healthy_run_equals_unguarded_and_rollback_replays_bit_identically(tmp_path):
    """A guarded run without faults is the unguarded run bit for bit. NaN
    at step 5 under 'rollback' (restore step 4, replay with 5 force-skipped)
    ends bit-identical to the 'skip' run, with the same per-step losses."""
    tm = _tiny()

    def run(**kw):
        return train_loop(tm, SyntheticBatchStream(tm.cfg, 4, 32, 8), lr=1e-3, total_steps=8,
                          microbatches=2, **kw)

    plain, _ = run()
    healthy, log_h = run(guard=GuardConfig(policy="skip"))
    _assert_same_state(_state_bits(plain), _state_bits(healthy))
    assert not log_h.events
    skip, log_a = run(guard=GuardConfig(policy="skip"),
                      faults=FaultPlan.from_specs(["nan_grad@step=5"]))
    rb, log_b = run(guard=GuardConfig(policy="rollback"),
                    faults=FaultPlan.from_specs(["nan_grad@step=5"]),
                    ckpt_dir=str(tmp_path / "rb"), ckpt_every=2, async_ckpt=False)
    kinds = [e["kind"] for e in log_b.events]
    assert "rollback" in kinds and "forced_skip" in kinds
    _assert_same_state(_state_bits(skip), _state_bits(rb))
    assert log_a.losses == log_b.losses and skip.opt_state["step"] == 7


def test_sigterm_writes_one_final_synchronous_checkpoint(tmp_path):
    tm = _tiny()

    class KillAt:
        """Raise SIGTERM just before yielding batch k (the handler runs at
        once on the main thread)."""

        def __init__(self, stream, k):
            self.stream, self.k = stream, k

        def __iter__(self):
            for i, b in enumerate(iter(self.stream)):
                if i == self.k:
                    signal.raise_signal(signal.SIGTERM)
                yield b

        def state_dict(self):
            return self.stream.state_dict()

        def load_state_dict(self, s):
            self.stream.load_state_dict(s)

    from repro_torch.checkpoint import CheckpointManager, checkpoint_steps

    prev = signal.getsignal(signal.SIGTERM)
    d = str(tmp_path / "sig")
    state, log = train_loop(tm, KillAt(SyntheticBatchStream(tm.cfg, 4, 32, 20), 4), lr=1e-3,
                            total_steps=20, ckpt_dir=d, ckpt_every=50)
    assert signal.getsignal(signal.SIGTERM) is prev  # handler restored
    assert [e["kind"] for e in log.events] == ["sigterm_checkpoint"]
    assert len(log.losses) == 5 and checkpoint_steps(d) == [5]
    assert CheckpointManager(d).restore_data_state() == {"step": 5}
    _, back = CheckpointManager(d).restore_train_state(tm.cfg)
    _assert_same_state(_state_bits(back), _state_bits(state))
