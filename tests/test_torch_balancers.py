"""Port vs reference: the rest of the balancer registry and the method
comparison — phi (φ-Balancing), lpr (Latent Prototype Routing),
expert_choice with its sentinel slots through the dispatch plan, the LP
oracle, the streaming gates (Algorithms 3 and 4), an lpr TrainState
through the npz checkpoint, three train steps per new method, and the
port's balance-sweep runner against the reference's.

Inputs are drawn with numpy from a seed and go through both packages.
Contracts, each with its reason:
  * route() on bit-identical scores (the port's compute_scores is fed the
    reference's): selections bitwise (the scores are tie-free); the carried
    'q' and 'proto' allclose at rtol 1e-6 (fp32 sums in another order),
    atol 1e-9 (phi's recentring cancels an entry to ~0, leaving an ulp of
    its ~1e-2 terms);
  * expert-choice: indices bitwise, weights allclose at rtol 1e-6 (the
    weights are the scores themselves, normalised or not), load and MaxVio
    equal, coverage the same counts of tokens (its means within an ulp:
    XLA multiplies a sum by 1/n where torch divides);
  * the dispatch plan with sentinel slots: pack bitwise (a gather), combine
    allclose at rtol 1e-6 (a weighted sum over the k slots), counts and
    MaxVio equal;
  * LP oracle: the HiGHS objective to 1e-9 (one solver, one input), the
    routing and greedy objectives exactly; streaming gates (host float64,
    one algorithm): selections and q bitwise;
  * checkpoints store bits: bitwise;
  * three train steps (tests/test_torch_train.py's contract): losses rtol
    1e-5, grad norm rtol 1e-3, q atol 1e-7, per-layer MaxVio equal;
  * the runner's reduced cell against the reference's: per-step MaxVio
    equal (the reference rounds it to 5 decimals), ppl rtol 1e-5 beside
    the reference's rounding to 3 decimals (atol 5e-4);
  * a paper_repro row against the reference's: MaxVio columns equal at the
    reference's rounding to 4 decimals, test perplexity rtol 1e-5 (the
    losses' contract); the paper's checks the same PASS/FAIL lines.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from _torch_train_util import ARCH, _cfgs, _t, _three_steps

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import store as jax_store  # noqa: E402
from repro.core import approx as jax_approx  # noqa: E402
from repro.core import balancers as jax_balancers  # noqa: E402
from repro.core import expert_choice as jax_ec  # noqa: E402
from repro.core import lp_oracle as jax_lp  # noqa: E402
from repro.core import metrics as jax_metrics  # noqa: E402
from repro.core import online as jax_online  # noqa: E402
from repro.core import router as jax_router  # noqa: E402
from repro.core.types import init_router_state as jax_init_state  # noqa: E402
from repro.data import make_batches as jax_make_batches  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import stack_blocks, train_state_from_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ApproxBIPGate,
    OnlineBIPGate,
    balance_metrics,
    expert_choice_route,
    expert_choice_select,
    get_balancer,
    greedy_balanced_objective,
    init_router_state,
    make_dispatch_plan,
    registered_balancers,
    route,
    routing_objective,
    solve_plp,
)
from repro_torch.core import router  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.launch import balance_sweep, paper_repro  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402

M, K = 16, 4


def _logits(rng, n=96, m=M, skew=1.0):
    return (rng.standard_normal((n, m)) * 1.5 + skew * np.linspace(-1, 1, m)).astype(np.float32)


def _scores(logits):
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def test_registry_equals_the_reference():
    assert registered_balancers() == jax_balancers.registered_balancers()
    assert registered_balancers() == (
        "aux_loss", "bip", "expert_choice", "lossfree", "lpr", "phi", "topk")


# ------------------------------------------------------------ phi and lpr


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("strategy", ["phi", "lpr"])
def test_route_matches_reference_over_carried_steps(strategy, masked, monkeypatch):
    """route() over 4 carried steps, each package carrying its own state:
    selections bitwise, q and proto allclose."""
    rc = jax_configs.get(ARCH).routing.to_router_config(strategy=strategy)
    tc = configs.get(ARCH).routing.to_router_config(strategy=strategy)
    monkeypatch.setattr(
        router, "compute_scores",
        lambda lg, cfg: _t(jax_router.compute_scores(jnp.asarray(lg.numpy()), rc)),
    )
    sj, st = jax_init_state(rc), init_router_state(tc)
    assert sorted(st) == sorted(sj) == (["proto", "q"] if strategy == "lpr" else ["q"])
    rng = np.random.default_rng(5)
    for _ in range(4):
        logits = _logits(rng)
        mask = rng.random(96) < 0.7 if masked else None
        oj = jax_router.route(jnp.asarray(logits), sj, rc,
                              token_mask=None if mask is None else jnp.asarray(mask))
        ot = router.route(_t(logits), st, tc, token_mask=None if mask is None else _t(mask))
        np.testing.assert_array_equal(ot.expert_index.numpy(), np.asarray(oj.expert_index))
        np.testing.assert_array_equal(ot.combine_weights.numpy(), np.asarray(oj.combine_weights))
        for key in sj:
            np.testing.assert_allclose(ot.state[key].numpy(), np.asarray(oj.state[key]),
                                       rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(ot.metrics["load"].numpy(), np.asarray(oj.metrics["load"]))
        sj, st = oj.state, ot.state
    if strategy == "phi":  # recentred, and moved by the skewed loads
        assert abs(float(st["q"].sum())) < 1e-6 and float(st["q"].abs().max()) > 0
    else:  # the prototypes left the identity; lpr keeps 'proto' out of the watchdog
        assert not torch.equal(st["proto"], torch.eye(M))
        assert get_balancer("lpr").guard_keys(st) == ("q",)


# ----------------------------------------------------------- expert choice


def _assert_same_shares(mt, mj, keys, n):
    """Coverage columns are means over n tokens: the same counts, and the
    means within an ulp (XLA multiplies the sum by 1/n, torch divides)."""
    for key in keys:
        a, b = float(mt[key]), float(mj[key])
        assert round(a * n) == round(b * n), key
        np.testing.assert_allclose(a, b, rtol=2e-7, err_msg=key)


@pytest.mark.parametrize("n,skew,norm", [(96, 1.0, False), (96, 3.0, True), (250, 3.0, False)])
def test_expert_choice_matches_reference(n, skew, norm):
    s = _scores(_logits(np.random.default_rng(n), n=n, skew=skew))
    gj, mj = jax_ec.expert_choice_route(jnp.asarray(s), K)
    gt, mt = expert_choice_route(_t(s), K)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(mt["load"].numpy(), np.asarray(mj["load"]))
    assert float(mt["max_vio"]) == float(mj["max_vio"]) == 0.0
    _assert_same_shares(mt, mj, ("coverage_full", "coverage_zero", "mean_experts_per_token"), n)
    np.testing.assert_allclose(float(mt["objective"]), float(mj["objective"]), rtol=1e-6)
    wj, ij = jax_ec.expert_choice_select(jnp.asarray(s), K, norm_topk_prob=norm)
    wt, it = expert_choice_select(_t(s), K, norm_topk_prob=norm)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6)
    assert int((it == M).sum()) > 0  # some tokens got fewer than k experts


def test_expert_choice_route_metrics_match_reference():
    """Through route(): MaxVio 0 by construction, the coverage columns."""
    rc = jax_configs.get(ARCH).routing.to_router_config(strategy="expert_choice")
    tc = configs.get(ARCH).routing.to_router_config(strategy="expert_choice")
    logits = _logits(np.random.default_rng(1), skew=3.0)
    oj = jax_router.route(jnp.asarray(logits), {"q": jnp.zeros(M)}, rc)
    ot = route(_t(logits), init_router_state(tc), tc)
    np.testing.assert_array_equal(ot.expert_index.numpy(), np.asarray(oj.expert_index))
    assert float(ot.metrics["max_vio"]) == float(oj.metrics["max_vio"]) == 0.0
    _assert_same_shares(ot.metrics, oj.metrics, ("coverage_full", "coverage_zero"), 96)
    assert float(ot.metrics["max_vio"]) == 0.0 and float(ot.metrics["coverage_full"]) < 1.0


@pytest.mark.parametrize("capacity,masked", [(24, False), (20, False), (24, True)])
def test_sentinel_dispatch_plan_matches_reference(capacity, masked):
    """An expert-choice selection (sentinel index m on spare slots) through
    make_dispatch_plan: no index error; pack, combine, counts and MaxVio
    equal to the reference's (whose clamped gather times weight 0 makes
    the sentinel slots vanish). Capacity 20 < C = 24 also drops real slots."""
    rng = np.random.default_rng(7)
    n, d = 96, 8
    s = _scores(_logits(rng, skew=3.0))
    w, idx = jax_ec.expert_choice_select(jnp.asarray(s), K)
    assert int((np.asarray(idx) == M).sum()) > 0
    mask = rng.random(n) < 0.8 if masked else None
    x = rng.standard_normal((n, d)).astype(np.float32)
    pj = jax_router.make_dispatch_plan(idx, M, capacity, None if mask is None else jnp.asarray(mask))
    pt = make_dispatch_plan(_t(np.asarray(idx)), M, capacity, None if mask is None else _t(mask))
    bj, bt = pj.pack(jnp.asarray(x)), pt.pack(_t(x))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    y = rng.standard_normal(bt.shape).astype(np.float32)
    np.testing.assert_allclose(pt.combine(_t(y), _t(np.asarray(w))).numpy(),
                               np.asarray(pj.combine(jnp.asarray(y), w)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pt.counts.numpy(), np.asarray(pj.counts))
    real = np.asarray(idx) < M
    np.testing.assert_array_equal(pt.keep.numpy(), np.asarray(pj.keep) & real)
    mj = jax_metrics.balance_metrics(idx, M, K)
    mt = balance_metrics(_t(np.asarray(idx)), M, K)
    assert float(mt["max_vio"]) == float(mj["max_vio"])
    np.testing.assert_array_equal(mt["load"].numpy(), np.asarray(mj["load"]))


def test_expert_choice_refuses_serving():
    """Training-only: the masked route() and the serving engine raise."""
    tc = configs.get(ARCH).routing.to_router_config(strategy="expert_choice")
    with pytest.raises(NotImplementedError, match="training-only"):
        route(torch.zeros(8, M), init_router_state(tc), tc, token_mask=torch.ones(8, dtype=torch.bool))
    rc = jax_configs.get(ARCH).routing.to_router_config(strategy="expert_choice")
    with pytest.raises(NotImplementedError, match="training-only"):
        jax_router.route(jnp.zeros((8, M)), {"q": jnp.zeros(M)}, rc, token_mask=jnp.ones(8, bool))
    _, tcfg = _cfgs("expert_choice", False)
    model = Model(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="training-only"):
        ContinuousBatchingEngine(model, model.init(0), n_slots=2, chunk_size=4, max_seq_len=16)


# ------------------------------------------------ LP oracle, streaming gates


@pytest.mark.parametrize("seed", [0, 1])
def test_lp_oracle_matches_reference(seed):
    rng = np.random.default_rng(seed)
    s = _scores(_logits(rng, n=48, m=8, skew=1.5))
    xj, oj = jax_lp.solve_plp(s, 2)
    xt, ot = solve_plp(torch.from_numpy(s), 2)
    assert abs(ot - oj) <= 1e-9 and xt.shape == xj.shape
    idx = np.argsort(-s, axis=-1)[:, :2]
    assert routing_objective(torch.from_numpy(s), torch.from_numpy(idx)) == jax_lp.routing_objective(s, idx)
    assert greedy_balanced_objective(s, 2) == jax_lp.greedy_balanced_objective(s, 2)
    assert greedy_balanced_objective(s, 2) <= ot + 1e-9


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("gate", ["online", "approx"])
def test_streaming_gates_match_reference(gate, adaptive):
    """One stream of 120 tokens: the port's gate takes torch rows, the
    reference's numpy rows; selections, gates and q bitwise at every
    token."""
    cls_t, cls_j = {"online": (OnlineBIPGate, jax_online.OnlineBIPGate),
                    "approx": (ApproxBIPGate, jax_approx.ApproxBIPGate)}[gate]
    gt, gj = cls_t(120, 8, 2, adaptive_capacity=adaptive), cls_j(120, 8, 2, adaptive_capacity=adaptive)
    s = _scores(_logits(np.random.default_rng(3), n=120, m=8, skew=1.5))
    picks = []
    for row in s:
        it, wt = gt.route(torch.from_numpy(row))
        ij, wj = gj.route(row)
        assert isinstance(it, np.ndarray) and isinstance(wt, np.ndarray)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(gt.q, gj.q)
        picks.append(it)
    stats_t, stats_j = gt.load_stats(np.stack(picks)), gj.load_stats(np.stack(picks))
    assert stats_t["max_vio"] == stats_j["max_vio"]


# ------------------------------------------------------------- checkpoints


def test_lpr_train_state_through_the_checkpoint_both_ways(tmp_path):
    """'proto' (m, m) per layer, (G, m, m) stacked: a reference checkpoint
    restores in the port bit-equal to the converted state, and a port
    checkpoint reads in the reference bit-equal to the port's protos."""
    jcfg, tcfg = _cfgs("lpr", False)
    jm, tm = jax_build_model(jcfg), Model(tcfg, device="cpu")
    jopt = jax_adamw.from_model_config(jm.cfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jopt)
    jstep = jax.jit(jax_loop.make_train_step(jm, jopt, jax_schedules.constant(1e-3)))
    js, _ = jstep(js, next(iter(jax_make_batches(jm.cfg, 4, 32, 1))))
    d = str(tmp_path / "ref")
    jax_store.CheckpointManager(d).save_train_state(js)
    _, ts = CheckpointManager(d).restore_train_state(tcfg)
    want = train_state_from_numpy(jax.device_get(js.params), jax.device_get(js.opt_state),
                                  jax.device_get(js.router_states), tcfg)
    for a, b in zip(ts.router_states, want.router_states):
        assert torch.equal(a["proto"], b["proto"]) and torch.equal(a["q"], b["q"])
    assert not torch.equal(ts.router_states[0]["proto"], torch.eye(M))  # one step moved it

    opt = adamw.from_model_config(tcfg)
    ps = init_train_state(tm, 0, opt)
    ps, _ = make_train_step(tm, opt, schedules.constant(1e-3))(ps, next(iter(make_batches(tcfg, 4, 32, 1))))
    d2 = str(tmp_path / "port")
    path = CheckpointManager(d2).save_train_state(ps, tcfg)
    tree = jax_store.load_pytree(path, verify=True)
    stacked = stack_blocks(ps.router_states, tcfg)
    for j, pos in enumerate(stacked):
        np.testing.assert_array_equal(np.asarray(tree["router_states"][j]["proto"]), pos["proto"].numpy())
    _, back = CheckpointManager(d2).restore_train_state(tcfg)
    for a, b in zip(back.router_states, ps.router_states):
        assert torch.equal(a["proto"], b["proto"])


# ----------------------------------------------------------- train steps


@pytest.mark.parametrize("strategy", ["phi", "lpr", "expert_choice"])
def test_three_train_steps_match_reference(strategy):
    for mj, mt, qj, qt in _three_steps(strategy, use_kernel=False):
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(qt, qj, atol=1e-7)
        np.testing.assert_array_equal(
            mt["max_vio_per_layer"].numpy(), np.asarray(mj["max_vio_per_layer"]))
        np.testing.assert_array_equal(mt["load_per_layer"].numpy(), np.asarray(mj["load_per_layer"]))
        if strategy == "expert_choice":
            assert float(mt["max_vio_per_layer"].max()) == 0.0


# ---------------------------------------------------------------- runner


def test_runner_cell_matches_reference():
    """balance_sweep.run_method against benchmarks.balance_sweep._run_method
    on the reference's sweep geometry, topk and phi for 2 steps from the
    reference's init (converted)."""
    from benchmarks import balance_sweep as ref_sweep

    jcfg, tcfg = ref_sweep._sweep_cfg(ARCH), balance_sweep.sweep_cfg(ARCH)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.routing.n_experts) == (
        jcfg.n_layers, jcfg.d_model, jcfg.routing.n_experts)
    for method in ("topk", "phi"):
        rj = ref_sweep._run_method(jcfg, method, 2, lr=1e-3)
        jm = jax_build_model(jcfg)
        js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jax_adamw.from_model_config(jcfg))
        ts = train_state_from_numpy(jax.device_get(js.params), jax.device_get(js.opt_state),
                                    jax.device_get(js.router_states), tcfg)
        rt = balance_sweep.run_method(tcfg, method, 2, lr=1e-3, state=ts, use_kernel=False, device="cpu")
        assert set(rj) <= set(rt)
        assert [[round(v, 5) for v in row] for row in rt["max_vio_per_step"]] == rj["max_vio_per_step"]
        np.testing.assert_allclose(rt["ppl_per_step"], rj["ppl_per_step"], rtol=1e-5, atol=5e-4)
        assert rt["first_step_max_vio"] == rj["first_step_max_vio"]
        assert rt["AvgMaxVio"] == rj["AvgMaxVio"] and rt["SupMaxVio"] == rj["SupMaxVio"]


def test_runner_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    rc = balance_sweep.main(["--device", "cpu", "--smoke", "--steps", "2", "--methods", "topk,bip",
                             "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert set(res["configs"]) == {"minimind-moe-16e", "minimind-moe-64e"}
    for entry in res["configs"].values():
        assert set(entry["methods"]) == {"topk", "bip"}
        for rec in entry["methods"].values():
            assert len(rec["max_vio_per_step"]) == 2 and all(np.isfinite(rec["loss_per_step"]))
        assert entry["methods"]["bip"]["AvgMaxVio"] < entry["methods"]["topk"]["AvgMaxVio"]
    assert "balance_sweep_minimind-moe-16e_bip," in capsys.readouterr().out
    bench = tmp_path / "BENCH_balance_sweep.json"
    with pytest.raises(SystemExit):
        balance_sweep.main(["--device", "cpu", "--steps", "1", "--out", str(bench)])
    assert not bench.exists()
    capsys.readouterr()
    with pytest.raises(SystemExit):  # the cross-shard lens runs under torch.distributed.run only
        balance_sweep.main(["--device", "cpu", "--sync", "global"])
    assert "torch.distributed.run --nproc-per-node 8" in capsys.readouterr().err


def test_router_level_compare_against_the_lp_oracle():
    """The registry-backed route() beside the LP optimum at the reference's
    sizes: bip near the optimum and balanced, top-k over it (it ignores the
    capacity), expert-choice perfectly balanced with partial coverage."""
    rows = balance_sweep.router_level_compare(methods=("bip", "bip[kernel]", "topk", "expert_choice"),
                                              seeds=(0,), device="cpu")
    agg = balance_sweep.aggregate_router_level(rows)
    from benchmarks import balance_sweep as ref_sweep

    ref = ref_sweep._aggregate_router_level(ref_sweep.router_level_compare(
        methods=("bip", "topk", "expert_choice"), seeds=(0,)))
    for method in ("topk", "expert_choice"):
        for col in ("max_vio", "coverage_full", "coverage_zero"):
            assert agg[method][col] == pytest.approx(ref[method][col], abs=1e-4), (method, col)
    assert agg["bip"]["max_vio"] < 0.2 and agg["topk"]["obj_ratio"] > 1.0
    assert agg["expert_choice"]["max_vio"] == 0.0 and agg["expert_choice"]["coverage_full"] < 1.0
    assert agg["bip[kernel]"]["max_vio"] < 0.3


def test_matrix_routes_its_router_level_columns_on_the_run_device(monkeypatch):
    """run_matrix hands its own device to router_level_compare, whose rows
    name the device the scores were routed on; its default is the card."""
    seen = []
    real = balance_sweep.router_level_compare

    def spy(**kw):
        rows = real(**kw)
        seen.extend(rows)
        return rows

    def cell(cfg, method, steps, **kw):
        return {"mean_step_time": 1e-3, "step_time_s": [1e-3], "first_step_max_vio": 0.5,
                "AvgMaxVio": 0.5, "SupMaxVio": 0.5, "final_ppl": 100.0, "step_time_p50": 1e-3}

    monkeypatch.setattr(balance_sweep, "router_level_compare", spy)
    monkeypatch.setattr(balance_sweep, "run_method", cell)
    res = balance_sweep.run_matrix(steps=1, methods=("topk", "bip"), reduced=True, data="",
                                   device="cpu")
    assert res["meta"]["device"] == "cpu" and not res["meta"]["full_width"]
    assert seen and {row["device"] for row in seen} == {"cpu"}
    assert set(res["router_level"]) == {"topk", "bip"}
    if torch.cuda.is_available():
        assert {r["device"] for r in real(seeds=(0,))} == {"cuda:0"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            real(seeds=(0,))


PAPER_ARCH = "minimind_moe_16e"


def test_paper_repro_row_matches_reference(monkeypatch):
    """launch/paper_repro.run_one against benchmarks/paper_repro.run_one:
    aux_loss for 2 steps from the reference's init (converted) on the
    reference's geometry, test perplexity included. Both packages' configs
    compute in bf16, whose roundings differ between XLA and torch and flip
    selections; the rows are compared with fp32 compute in both (configs.get
    patched), after the geometries, dtypes included, are held equal."""
    from benchmarks import paper_repro as ref_repro

    tcfg = paper_repro.repro_cfg(PAPER_ARCH)
    jbase = jax_configs.get(PAPER_ARCH)
    jcfg = dataclasses.replace(
        jbase, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, moe_d_ff=256,
        d_ff=256, vocab_size=512, max_seq_len=128, attn_chunk=64,
        routing=dataclasses.replace(jbase.routing, strategy="aux_loss", bip_iters=0))
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "moe_d_ff", "d_ff",
                 "vocab_size", "max_seq_len", "attn_chunk", "attn_pattern"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for name in ("param_dtype", "compute_dtype"):
        assert str(getattr(tcfg, name)).removeprefix("torch.") == np.dtype(getattr(jcfg, name)).name
    assert (tcfg.routing.n_experts, tcfg.routing.top_k) == (jcfg.routing.n_experts, jcfg.routing.top_k)

    def fp32(get, dtype):
        return lambda name: dataclasses.replace(get(name), compute_dtype=dtype)

    monkeypatch.setattr(jax_configs, "get", fp32(jax_configs.get, jnp.float32))
    monkeypatch.setattr(configs, "get", fp32(configs.get, torch.float32))
    rj = ref_repro.run_one(PAPER_ARCH, "aux_loss", 0, steps=2)
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
    jm = jax_build_model(jcfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jax_adamw.from_model_config(jcfg))
    tcfg = paper_repro.repro_cfg(PAPER_ARCH)
    assert tcfg.compute_dtype == torch.float32
    ts = train_state_from_numpy(jax.device_get(js.params), jax.device_get(js.opt_state),
                                jax.device_get(js.router_states), tcfg)
    rt = paper_repro.run_one(PAPER_ARCH, "aux_loss", 0, steps=2, state=ts, device="cpu")
    assert rt["strategy"] == rj["strategy"] == "aux_loss"
    for col in ("AvgMaxVio", "SupMaxVio", "first_batch_maxvio"):
        assert round(rt[col], 4) == rj[col], col
    assert [round(v, 4) for v in rt["maxvio_trajectory"]] == rj["maxvio_trajectory"]
    assert [round(v, 4) for v in rt["AvgMaxVio_per_layer"]] == rj["AvgMaxVio_per_layer"]
    np.testing.assert_allclose(rt["perplexity"], rj["perplexity"], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_paper_repro_tables_and_checks_match_reference(seed, monkeypatch, capsys, tmp_path):
    """Both packages' table() and main() over the same rows (run_one stubbed
    with seeded numbers, so the checks come out mixed): the port prints the
    reference's PASS/FAIL lines, and its JSON holds the same rows."""
    from benchmarks import paper_repro as ref_repro

    def fake_run_one(base_arch, strategy, bip_iters, *, steps, **kw):
        rng = np.random.default_rng([seed, len(base_arch), len(strategy), bip_iters])
        sup = float(rng.uniform(0.1, 3.0))
        return {"strategy": strategy if strategy != "bip" else f"bip_T{bip_iters}",
                "AvgMaxVio": round(sup * float(rng.uniform(0.3, 1.0)), 4), "SupMaxVio": round(sup, 4),
                "perplexity": round(float(rng.uniform(500, 540)), 4), "train_wall_s": 0.1,
                "first_batch_maxvio": round(float(rng.uniform(0.1, sup)), 4)}

    monkeypatch.setattr(ref_repro, "run_one", fake_run_one)
    monkeypatch.setattr(paper_repro, "run_one", fake_run_one)
    ref_tables = ref_repro.main(steps=1, out=str(tmp_path / "ref.json"))
    ref_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.endswith(("PASS", "FAIL"))]
    assert paper_repro.main(["--steps", "1", "--device", "cpu", "--out", str(tmp_path / "port.json")]) == 0
    port_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.endswith(("PASS", "FAIL"))]
    assert len(port_lines) == 8 and port_lines == ref_lines
    assert json.loads((tmp_path / "port.json").read_text()) == ref_tables
