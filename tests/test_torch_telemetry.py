"""Port vs reference: training observability and the last single-device
training flags (telemetry/metrics.py, trace.py, metrics_report.py, the bip
dual forecaster, the dual watchdog in training, local_shards).

Contracts, as the port's other parity tests hold them: integers (load
histograms, ring slots, record steps) bit-equal; under topk the fp32
record columns allclose at rtol 1e-5 (the grad norm at rtol 1e-3, as
tests/test_torch_train.py holds it); under bip, whose routing is
LP-degenerate (a capacity-marginal token may route to the other, equally
optimal expert), MaxVio within one token. Telemetry itself is held
BITWISE: a run with it is the run without it, in every param, moment,
router state and loss. The reference runs eagerly on the CPU (Pallas kernels in
interpret mode where its path reaches them), as its own tests run it.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import store as jax_store  # noqa: E402
from repro.core import ref_bip as jax_ref_bip  # noqa: E402
from repro.core import router as jax_router  # noqa: E402
from repro.core.types import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.core.types import init_router_state as jax_init_router_state  # noqa: E402
from repro.data.synthetic import SyntheticBatchStream as JaxStream  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.telemetry import MemorySink as JaxMemorySink  # noqa: E402
from repro.telemetry import MetricStream as JaxMetricStream  # noqa: E402
from repro.telemetry import TrainTelemetry as JaxTrainTelemetry  # noqa: E402
from repro.telemetry import metrics_report as jax_report  # noqa: E402
from repro.telemetry import profile_window as jax_profile_window  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import router_states_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.core import ref_bip, router  # noqa: E402
from repro_torch.core.types import RouterConfig, init_router_state  # noqa: E402
from repro_torch.data import SyntheticBatchStream  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.robustness import GuardConfig  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    MemorySink,
    MetricStream,
    Profiler,
    TrainTelemetry,
    metrics_report,
    profile_window,
)
from repro_torch.training import train_loop  # noqa: E402

ARCH = "minimind_moe_16e"
SPANS = ("train/fwd_bwd", "train/apply", "router/score_adjust", "router/select",
         "router/update_state", "moe/dispatch", "moe/gemm", "moe/combine", "telemetry/accumulate")


def _cfgs(strategy="bip", use_kernel=False, **routing):
    """Reduced minimind-16e with the full routing table (16 experts top-4)."""
    out = []
    for pkg in (jax_configs, configs):
        full = pkg.get(ARCH)
        r = dataclasses.replace(full.routing, strategy=strategy, use_kernel=use_kernel, **routing)
        out.append(pkg.reduced_for_smoke(ARCH, routing=r, vocab_size=128))
    return out


def _state_leaves(ts):
    return adamw.tree_paths({"p": ts.params, "mu": ts.opt_state["mu"], "nu": ts.opt_state["nu"],
                             "r": ts.router_states})


def _assert_states_bit_equal(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), path
    assert a.opt_state["step"] == b.opt_state["step"]


def _port_run(tcfg, steps, state=None, batch=4, **kw):
    model = Model(tcfg, device="cpu")
    return train_loop(model, SyntheticBatchStream(tcfg, batch, 32, steps, device="cpu"), lr=1e-3,
                      warmup_steps=1, total_steps=steps, state=state, **kw)


# ------------------------------------------------- records against the reference

N_REC, B_REC = 4, 4


@pytest.fixture(scope="module", params=["topk", "bip"])
def runs(request):
    """Both packages' train_loop with telemetry (flush_every 3: a partial
    last window) from one TrainState, the reference's init converted,
    batches of B_REC x 32. bip runs the main path's dual, K3 (its plain
    version here, the reference's Pallas kernel in interpret mode): the
    exact sort-based dual parks q on a token's score and makes the
    capacity ties degenerate."""
    jcfg, tcfg = _cfgs(request.param, use_kernel=request.param == "bip")
    jm = jax_build_model(jcfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jax_adamw.from_model_config(jcfg))
    ts = train_state_from_numpy(jax.device_get(js.params), jax.device_get(js.opt_state),
                                jax.device_get(js.router_states), tcfg, "cpu")
    jsink, tsink = JaxMemorySink(), MemorySink()
    jtel, ttel = JaxTrainTelemetry(jsink, flush_every=3), TrainTelemetry(tsink, flush_every=3)
    jax_loop.train_loop(jm, JaxStream(jcfg, B_REC, 32, N_REC), lr=1e-3, warmup_steps=1,
                        total_steps=N_REC, state=js, telemetry=jtel)
    _, tlog = _port_run(tcfg, N_REC, state=ts, telemetry=ttel, batch=B_REC)
    return request.param, tcfg, jtel, ttel, jsink.records, tsink.records, tlog


def test_metric_stream_layout_matches_reference(runs):
    """(a) One step's metrics give the reference's keys, shapes and
    integer/float kinds; float loads are refused, oversized entries skipped,
    bool stored as int32 (for one hand-made metrics dict in both packages)."""
    _, _, jtel, ttel, *_ = runs
    kind = lambda integer: "int" if integer else "float"  # noqa: E731
    jl = {k: (tuple(s), kind(jnp.issubdtype(d, jnp.integer))) for k, (s, d) in jtel.stream.layout.items()}
    tl = {k: (tuple(s), kind(d == torch.int32)) for k, (s, d) in ttel.stream.layout.items()}
    assert tl == jl
    assert tl["load_per_layer"][1] == "int" and ttel.stream.layout["load_per_layer"][1] == torch.int32

    rng = np.random.default_rng(0)
    mets = {"loss": np.float32(rng.random()), "load": rng.integers(0, 9, (16,)).astype(np.int32),
            "ok": np.bool_(True), "big": np.zeros(70000, np.float32), "vec": rng.random(3).astype(np.float32)}
    jmets = {k: jnp.asarray(v) for k, v in mets.items()}
    tmets = {k: torch.from_numpy(np.asarray(v)) for k, v in mets.items()}
    tmets["lr"], jmets["lr"] = 0.5, jnp.float32(0.5)  # a host scalar in the port's step
    jl = JaxMetricStream.build(jmets, 4).layout
    tl = MetricStream.build(tmets, 4).layout
    assert sorted(tl) == sorted(jl) == ["load", "loss", "lr", "ok", "vec"]
    for k in tl:
        assert tuple(tl[k][0]) == tuple(jl[k][0]), k
        assert (tl[k][1] == torch.int32) == bool(jnp.issubdtype(jl[k][1], jnp.integer)), k
    assert tl["ok"][1] == torch.int32 and tl["lr"] == ((), torch.float32)
    for bad in (torch.zeros(16), 1.5):
        with pytest.raises(AssertionError, match="integer counts"):
            MetricStream.build({"load": bad}, 4)


def test_records_match_reference(runs):
    """(d) The port's records against the reference's: one record per step,
    same keys, loads summing to n·k per layer; under topk the integer loads
    bit-equal and the fp32 columns allclose; under bip MaxVio within one
    token and the train contract of its kernel path."""
    strategy, tcfg, _, _, jrec, trec, tlog = runs
    jsteps = [r for r in jrec if r["kind"] == "train_step"]
    tsteps = [r for r in trec if r["kind"] == "train_step"]
    assert [r["step"] for r in tsteps] == [r["step"] for r in jsteps] == list(range(N_REC))
    assert set(tsteps[0]) == set(jsteps[0])
    m, k = tcfg.routing.n_experts, tcfg.routing.top_k
    mean_load = B_REC * 32 * k / m
    for rj, rt in zip(jsteps, tsteps):
        lj, lt = np.asarray(rj["load_per_layer"]), np.asarray(rt["load_per_layer"])
        assert lt.shape == lj.shape == (2, m) and lt.dtype.kind == "i"
        np.testing.assert_array_equal(lt.sum(axis=1), np.full(2, B_REC * 32 * k))
        if strategy == "topk":
            np.testing.assert_array_equal(lt, lj)
            np.testing.assert_array_equal(rt["max_vio_per_layer"], rj["max_vio_per_layer"])
        else:
            vio = np.abs(np.asarray(rt["max_vio_per_layer"]) - np.asarray(rj["max_vio_per_layer"]))
            assert (vio * mean_load).max() <= 1.0 + 1e-6, vio
        np.testing.assert_allclose(rt["lr"], rj["lr"], rtol=1e-6)
        # topk: fp32 columns at 1e-5; bip: the kernel path's train contract
        # (tests/test_torch_train.py: losses rtol 1e-4, q atol 0.01)
        rtol = 1e-5 if strategy == "topk" else 1e-4
        for key in ("loss", "ce_loss", "perplexity", "aux_loss"):
            np.testing.assert_allclose(rt[key], rj[key], rtol=rtol, atol=1e-7, err_msg=key)
        np.testing.assert_allclose(rt["grad_norm"], rj["grad_norm"], rtol=1e-3)
        if strategy == "topk":
            for key in ("dropped_frac_cap1_per_layer", "q_abs_max_per_layer"):
                np.testing.assert_allclose(rt[key], rj[key], rtol=1e-5, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_allclose(rt["q_abs_max_per_layer"], rj["q_abs_max_per_layer"], atol=0.01)
    # the records carry what TrainLog folds
    np.testing.assert_array_equal([r["ce_loss"] for r in tsteps], np.float32(tlog.losses))


def test_metrics_report_matches_reference(runs, tmp_path):
    """(e) summarize() of the port and of the reference agree on one file,
    a replayed step included (the last record of a step wins), and give
    TrainLog's per-layer AvgMaxVio."""
    _, _, _, _, _, trec, tlog = runs
    path = tmp_path / "run.jsonl"
    replay = dict(trec[-1], ce_loss=0.25)
    with open(path, "w") as f:
        for r in trec + [{"kind": "event", "step": 1, "what": "x"}, replay]:
            f.write(json.dumps(r) + "\n")
        f.write('{"kind": "train_st')  # a torn last line
    recs_t, recs_j = metrics_report.load_records(str(path)), jax_report.load_records(str(path))
    assert recs_t == recs_j
    st_, sj = metrics_report.summarize(recs_t), jax_report.summarize(recs_j)
    assert st_ == sj
    assert st_["n_steps"] == N_REC and st_["final_loss"] == 0.25
    np.testing.assert_allclose(st_["AvgMaxVio_per_layer"], tlog.summary()["AvgMaxVio_per_layer"], rtol=1e-6)
    html = tmp_path / "r.html"
    assert metrics_report.main([str(path), "--html", str(html)]) == 0
    assert "layer 0 per-expert load" in html.read_text()


# ---------------------------------------------------------------- the ring


def test_ring_slots_partial_windows_and_finish():
    """(b) slot = step % flush_every; unwritten slots (-1) are skipped on the
    drain; a partial last window drains at finish(); the records equal the
    reference's driven the same way."""
    stream = MetricStream({"x": ((), torch.float32)}, 3)
    buf = stream.init_buffer()
    assert stream.read(buf)["_step"].tolist() == [-1, -1, -1]
    for i in range(4):  # wraps: slot 0 overwritten by step 3
        buf = stream.accumulate(buf, {"x": torch.tensor(float(i))}, i)
    got = stream.read(buf)
    assert got["_step"].tolist() == [3, 1, 2] and got["x"].tolist() == [3.0, 1.0, 2.0]

    rng = np.random.default_rng(1)
    steps = [dict(x=rng.random(2).astype(np.float32), load=rng.integers(0, 5, (2, 4)),
                  ok=np.bool_(i % 2), lr=float(i) / 8) for i in range(7)]
    out = []
    for pkg in ("ref", "port"):
        sink = JaxMemorySink() if pkg == "ref" else MemorySink()
        tel = (JaxTrainTelemetry if pkg == "ref" else TrainTelemetry)(sink, flush_every=3)
        for i, mets in enumerate(steps):
            if pkg == "ref":
                m = {k: jnp.asarray(v) for k, v in mets.items()}
                m["load"] = m["load"].astype(jnp.int32)
                tel.ensure_built(m)
                buf = tel.stream.accumulate(tel.buf, m, jnp.asarray(i, jnp.int32))
            else:
                m = {k: (v if k == "lr" else torch.from_numpy(np.asarray(v))) for k, v in mets.items()}
                tel.ensure_built(m)
                buf = tel.stream.accumulate(tel.buf, m, i)
            tel.note_step_time(i, 0.01 * i)
            tel.after_step(i, buf)
            if i == 4:  # window [0, 2] was drained at step 2 and is still in flight
                assert sink.records == []
            if i == 5:  # the drain of [3, 5] materializes [0, 2]
                assert [r["step"] for r in sink.records] == [0, 1, 2]
        tel.finish()
        assert tel.n_records == 7
        out.append(sink.records)
    assert out[1] == out[0]


# ------------------------------------------------------- bitwise transparency


@pytest.mark.parametrize("case", ["topk", "bip_guarded_forecast_global"])
def test_telemetry_is_bitwise_transparent(case):
    """(c) 3 train steps with and without telemetry: every param, moment,
    router state and loss bitwise equal (bip: the guarded step, the
    forecaster and the global-sync bisection dual, the hardest case)."""
    if case == "topk":
        _, tcfg = _cfgs("topk")
        kw = {}
    else:
        _, tcfg = _cfgs("bip", sync="global", forecast=True)
        kw = {"guard": GuardConfig(policy="skip")}
    s0, l0 = _port_run(tcfg, 3, **kw)
    sink = MemorySink()
    s1, l1 = _port_run(tcfg, 3, telemetry=TrainTelemetry(sink, flush_every=2), **kw)
    _assert_states_bit_equal(s0, s1)
    assert l0.losses == l1.losses
    assert [r["step"] for r in sink.records if r["kind"] == "train_step"] == [0, 1, 2]
    if case != "topk":
        assert all("forecast_hit_per_layer" in r for r in sink.records)


def test_guard_events_reach_the_sink_once_in_order():
    """The guard ladder's events go to the telemetry sink as they happen,
    each once, in order, and the skipped step's row is still recorded."""
    from repro_torch.robustness import FaultPlan

    _, tcfg = _cfgs("topk")
    sink = MemorySink()
    _, log = _port_run(tcfg, 4, guard=GuardConfig(policy="skip"),
                       faults=FaultPlan.from_specs(["nan_grad@step=1,2"]),
                       telemetry=TrainTelemetry(sink, flush_every=3))
    events = [r for r in sink.records if r["kind"] != "train_step"]
    assert len(events) >= 2 and json.dumps(events) == json.dumps(log.events)  # NaN losses as NaN
    rows = {r["step"]: r for r in sink.records if r["kind"] == "train_step"}
    assert sorted(rows) == [0, 1, 2, 3] and rows[1]["step_ok"] == 0 and rows[3]["step_ok"] == 1


# ---------------------------------------------------------------- tracing


def test_profile_window_and_cpu_trace(tmp_path):
    """(f) profile_window raises the reference's errors on the same specs;
    a CPU Profiler window captures exactly its steps, with the span names."""
    for spec in ("3:10", "0:0", None, ""):
        assert profile_window(spec) == jax_profile_window(spec)
    for spec in ("10:3", "abc", "1:2:3", "-1:2"):
        with pytest.raises(ValueError):
            jax_profile_window(spec)
        with pytest.raises(ValueError, match="--profile"):
            profile_window(spec)
    _, tcfg = _cfgs("bip")
    prof = Profiler((1, 1), log_dir=str(tmp_path / "profile"))
    _port_run(tcfg, 3, telemetry=TrainTelemetry(None, flush_every=2, profiler=prof))
    assert not prof.active
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    for span in SPANS:
        assert span in names, span
    assert names.count("train/fwd_bwd") == 1  # steps 0 and 2 were not captured
    assert names.count("router/score_adjust") == 2  # one per MoE layer


# ------------------------------------------------------- the dual forecaster


@given(seed=st.integers(0, 2**31 - 1), fanout=st.sampled_from([1, 4, 32]),
       good=st.sampled_from([True, False]))
@settings(max_examples=12, deadline=None)
def test_window_threshold_is_bit_equal(seed, fanout, good):
    """(g) kth_largest_threshold with a valid or a stale forecast window is
    bit-equal to the reference's with the same window (per-column windows,
    as the router passes them)."""
    rng = np.random.default_rng(seed)
    n, cols, kth = 200, 3, 10
    x = rng.standard_normal((n, cols)).astype(np.float32)
    want = np.sort(x, axis=0)[::-1][kth]
    shift = np.float32(0.0 if good else 1.5)
    w = ((want - 0.05 + shift).astype(np.float32), (want + 0.05 + shift).astype(np.float32))
    ref = jax_ref_bip.kth_largest_threshold(jnp.asarray(x), kth, axis=0, fanout=fanout,
                                            window=tuple(jnp.asarray(v) for v in w))
    got = ref_bip.kth_largest_threshold(torch.from_numpy(x), kth, dim=0, fanout=fanout,
                                        window=tuple(torch.from_numpy(v) for v in w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ((x > got.numpy()[None]).sum(axis=0) <= kth).all()


def _same_scores(monkeypatch, rc):
    """The port's route() on the reference's softmax output: XLA's and
    torch's exp differ in the last ulp (tests/test_torch_router.py)."""
    monkeypatch.setattr(router, "compute_scores", lambda lg, cfg: torch.from_numpy(
        np.array(jax_router.compute_scores(jnp.asarray(lg.numpy()), rc))))


def test_route_forecast_over_five_calls_matches_reference(monkeypatch):
    """(g) route(sync='global', forecast=True), 5 warm calls: q, q_ema, q_err
    within 1e-7 of the reference's, and its forecast telemetry."""
    kw = dict(n_experts=16, top_k=4, strategy="bip", sync="global", forecast=True)
    rc, tc = JaxRouterConfig(**kw), RouterConfig(**kw)
    _same_scores(monkeypatch, rc)
    sj, stt = jax_init_router_state(rc), init_router_state(tc)
    assert sorted(stt) == sorted(sj) == ["q", "q_ema", "q_err"]
    rng = np.random.default_rng(3)
    skew = np.linspace(-1, 1, 16)
    for _ in range(5):
        logits = (rng.standard_normal((256, 16)) * 1.5 + skew).astype(np.float32)
        oj = jax_router.route(jnp.asarray(logits), sj, rc)
        ot = router.route(torch.from_numpy(logits), stt, tc)
        for key in ("q", "q_ema", "q_err"):
            np.testing.assert_allclose(ot.state[key].numpy(), np.asarray(oj.state[key]), atol=1e-7,
                                       err_msg=key)
        for key in ("forecast_err", "forecast_hit"):
            np.testing.assert_allclose(float(ot.metrics[key]), float(oj.metrics[key]), atol=1e-6)
        sj, stt = oj.state, ot.state
    assert float(ot.metrics["forecast_hit"]) > 0  # the EMA has warmed up


# ------------------------------------------------- watchdog and local_shards


def test_dual_watchdog_in_training_resets_poisoned_state():
    """(h) The watchdog as tests/test_robustness.py holds it: a poisoned q
    (NaN, runaway) or forecaster EMA resets every guarded key to the
    fresh-layer trajectory, bit for bit; off == on for healthy carries. In
    training, a NaN q of layer 0 before step 1 is reset and the run goes
    on finite."""
    kw = dict(n_experts=8, top_k=2, strategy="bip", sync="global", forecast=True)
    cfg, cfg_off = RouterConfig(guard_duals=True, **kw), RouterConfig(**kw)
    st0 = init_router_state(cfg)
    logits = torch.from_numpy(np.random.RandomState(0).randn(32, 8).astype(np.float32))
    healthy = router.route(logits, st0, cfg)
    for poison in ({"q": torch.full((8,), float("nan"))}, {"q": torch.full((8,), 1e6)},
                   {"q_err": torch.full((8,), float("inf"))}):
        out = router.route(logits, {**st0, **poison}, cfg)
        for k, v in out.state.items():
            assert torch.isfinite(v).all(), k
        assert torch.equal(out.state["q"], healthy.state["q"])
    ref = router.route(logits, st0, cfg_off)
    for k in ref.state:
        assert torch.equal(ref.state[k], healthy.state[k]), k

    for guard in (False, True):
        _, tcfg = _cfgs("bip", guard_duals=guard)
        s_a, l_a = _port_run(tcfg, 2)
        if guard:
            assert l_a.losses == l_plain.losses and all(torch.equal(a, b) for (_, a), (_, b) in
                                                 zip(_state_leaves(s_a), _state_leaves(s_plain)))
        s_plain, l_plain = s_a, l_a
    # poison layer 0's carried q before the third step
    model = Model(tcfg, device="cpu")
    state = s_plain
    state.router_states[0]["q"] = torch.full_like(state.router_states[0]["q"], float("nan"))
    sink = MemorySink()
    stream = SyntheticBatchStream(tcfg, 4, 32, 1, device="cpu", seed=5)
    state, log = train_loop(model, stream, lr=1e-3, warmup_steps=1, total_steps=1, state=state,
                            telemetry=TrainTelemetry(sink, flush_every=1))
    assert np.isfinite(log.losses).all() and torch.isfinite(state.router_states[0]["q"]).all()


def test_route_local_shards_matches_reference(monkeypatch):
    """(i) route(local_shards=2): per-group duals, their mean as the carried
    warm start, as the reference (tests/test_core_router.py)."""
    kw = dict(n_experts=8, top_k=2, strategy="bip", bip_iters=8, sync="local")
    rc, tc = JaxRouterConfig(**kw), RouterConfig(**kw)
    _same_scores(monkeypatch, rc)
    logits = np.random.default_rng(5).standard_normal((512, 8)).astype(np.float32)
    oj = jax_router.route(jnp.asarray(logits), jax_init_router_state(rc), rc, local_shards=2)
    ot = router.route(torch.from_numpy(logits), init_router_state(tc), tc, local_shards=2)
    np.testing.assert_allclose(ot.state["q"].numpy(), np.asarray(oj.state["q"]), atol=1e-7)
    np.testing.assert_array_equal(ot.expert_index.numpy(), np.asarray(oj.expert_index))
    assert float(ot.metrics["max_vio"]) < 0.3
    one = router.route(torch.from_numpy(logits), init_router_state(tc), tc)
    assert not torch.equal(one.state["q"], ot.state["q"])  # the groups solved apart


# ---------------------------------------------------- checkpoint and the CLIs


def test_forecast_checkpoint_resumes_bit_exact_across_packages(tmp_path):
    """(j) The forecaster's q_ema/q_err ride the checkpoint: a --forecast run
    resumed from step 2 replays steps 2-3 bit-exactly; the file passes the
    reference's verify and restores there with the EMAs, and back."""
    _, tcfg = _cfgs("bip", sync="global", forecast=True)
    s_ref, l_ref = _port_run(tcfg, 4)
    d = str(tmp_path / "ck")
    _port_run(tcfg, 2, ckpt_dir=d, ckpt_every=2, async_ckpt=False)
    step, jstate = jax_store.CheckpointManager(d).restore_train_state()
    assert step == 2
    for s in jstate.router_states:
        assert s is None or {"q", "q_ema", "q_err"} <= set(s)
    live = [s for s in jstate.router_states if s is not None]
    assert any(np.abs(np.asarray(s["q_ema"])).sum() > 0 for s in live)
    model = Model(tcfg, device="cpu")
    s_res, l_res = train_loop(model, SyntheticBatchStream(tcfg, 4, 32, 4, device="cpu"), lr=1e-3,
                              warmup_steps=1, total_steps=4, ckpt_dir=d, resume=True)
    assert l_res.losses == l_ref.losses[2:]
    _assert_states_bit_equal(s_res, s_ref)
    # the reference's state back into the port, leaf for leaf
    back = router_states_from_numpy(jax.device_get(jstate.router_states), tcfg)
    _, mine = CheckpointManager(d).restore_train_state(tcfg)
    for a, b in zip(back, mine.router_states):
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_train_and_serve_clis_with_the_new_flags(tmp_path, monkeypatch, capsys):
    """(k) launch.train with every observability and routing flag of this
    slice on the CPU, and launch.serve with --profile."""
    from repro_torch.launch import serve, train

    monkeypatch.chdir(tmp_path)  # ./profile lands here
    tel = tmp_path / "t.jsonl"
    rc = train.main(["--arch", "minimind-moe-16e", "--reduced", "--device", "cpu", "--steps", "4",
                     "--batch", "2", "--seq-len", "16", "--log-every", "0", "--telemetry", str(tel),
                     "--flush-every", "2", "--profile", "1:2", "--forecast", "--sync", "global",
                     "--guard-duals", "--n-bisect", "20", "--bisect-fanout", "8",
                     "--forecast-decay", "0.8", "--forecast-margin", "3", "--bf16"])
    assert rc == 0
    recs = metrics_report.load_records(str(tel))
    assert recs[0]["kind"] == "run_meta" and recs[0]["sync"] == "global"
    steps = [r for r in recs if r["kind"] == "train_step"]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert all("forecast_hit_per_layer" in r for r in steps)
    traces = list((tmp_path / "profile").glob("*.json"))
    assert len(traces) == 1 and "train/fwd_bwd" in traces[0].read_text()
    with pytest.raises(SystemExit):  # a TPU-pod flag of the reference stays refused
        train.main(["--arch", "minimind-moe-16e", "--reduced", "--device", "cpu", "--production"])
    capsys.readouterr()
    assert serve.main(["--arch", "minimind-moe-16e", "--reduced", "--device", "cpu", "--requests", "3",
                       "--n-slots", "2", "--chunk", "8", "--gen", "3", "--profile", "1:2"]) == 0
    assert "profile -> profile/steps_1-2.pt.trace.json" in capsys.readouterr().out
    assert '"serve/step"' in (tmp_path / "profile" / "steps_1-2.pt.trace.json").read_text()
