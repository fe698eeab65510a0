"""Port vs reference, and the port against itself: the training tests
that run longer loops — the train CLI (synthetic, and real text with a
checkpoint and a bit-exact resume), packed-document forwards and the
segment mask, the reproducible CPU backward, microbatched steps, the
guarded step, the guard ladder in train_loop, rollback and SIGTERM.
Moved unchanged out of tests/test_torch_train.py (which keeps the
balancer, model, optimizer, data and three-step tests); the contracts and
their tolerances are stated there and repeated where a test uses them:
  * forward fp32: rtol/atol 1e-4; losses rtol 1e-5;
  * microbatched steps: topk/aux_loss/lossfree losses rtol 1e-5, grad norm
    rtol 1e-3, router states atol 1e-7, MaxVio and load equal; bip on the
    K3 kernel path losses rtol 1e-4, q atol 0.01, MaxVio within 0.1;
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

from _torch_train_util import _cfgs, _t, _three_steps

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticBatchStream as JaxStream  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.data import SyntheticBatchStream, make_batches  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.robustness import FaultPlan, GuardConfig  # noqa: E402
from repro_torch.training import (  # noqa: E402
    init_train_state,
    make_train_step,
    train_loop,
)


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
