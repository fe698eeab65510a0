"""Port vs reference: the continuous-batching engine end to end, the port's
import boundary, and its device rule.

Both engines serve reduced minimind-moe-16e (full 16e/top-4 routing table)
with use_kernel=True on the same converted parameters, prompts no longer
than a chunk, greedy decoding.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402

ARCH = "minimind_moe_16e"
ROOT = Path(__file__).resolve().parents[1]


def _serve_both(strategy):
    jfull, tfull = jax_configs.get(ARCH), configs.get(ARCH)
    jcfg = jax_configs.reduced_for_smoke(
        ARCH, routing=dataclasses.replace(jfull.routing, strategy=strategy), vocab_size=128
    )
    tcfg = configs.reduced_for_smoke(
        ARCH, routing=dataclasses.replace(tfull.routing, strategy=strategy), vocab_size=128
    )
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    kw = dict(n_slots=3, chunk_size=8, max_seq_len=32, use_kernel=True)
    je = JaxEngine(jm, jp, **kw)
    te = ContinuousBatchingEngine(Model(tcfg, device="cpu"), tp, **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, (int(rng.integers(2, 9)),)) for _ in range(5)]
    jr = [je.submit(p, 5, ignore_eos=True) for p in prompts]
    tr = [te.submit(p, 5, ignore_eos=True) for p in prompts]
    je.run()
    te.run()
    assert te.model.cfg.routing.use_kernel
    return je, jr, te, tr


def test_engine_matches_reference_topk():
    """Top-k routing is score-deterministic: identical token streams, steps
    and per-expert load."""
    je, jr, te, tr = _serve_both("topk")
    assert [r.output for r in tr] == [r.output for r in jr]
    assert (te.n_steps, te.prefill_tokens, te.decode_tokens) == (
        je.n_steps, je.prefill_tokens, je.decode_tokens,
    )
    np.testing.assert_array_equal(te.expert_load, je.expert_load)


def test_engine_matches_reference_bip():
    """BIP routing: identical token streams and identical total expert load.
    Per-expert load may differ by the LP-degenerate marginal tokens (see
    test_torch_model.py::test_teacher_forced_prefill_chunks_bip), bounded
    here by a quarter of the total."""
    je, jr, te, tr = _serve_both("bip")
    assert [r.output for r in tr] == [r.output for r in jr]
    assert te.expert_load.sum() == je.expert_load.sum()
    assert np.abs(te.expert_load - je.expert_load).sum() <= je.expert_load.sum() / 4


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _lifecycle(engine_cls, model, params, scenario):
    """Drive one robustness scenario on a fake clock; returns each request's
    (finish_reason, n_generated) in submit order and the engine counters."""
    clk = FakeClock()
    kw = dict(n_slots=2, chunk_size=8, max_seq_len=64, clock=clk)
    if scenario == "deadline":
        eng = engine_cls(model, params, default_deadline=2.5, **kw)
        reqs = [eng.submit(list(range(1, 6)), 20, ignore_eos=True) for _ in range(4)]
    elif scenario == "queue_timeout":
        eng = engine_cls(model, params, queue_timeout=1.5, **dict(kw, n_slots=1))
        reqs = [eng.submit([1, 2, 3], 30, ignore_eos=True), eng.submit([4, 5, 6], 4, ignore_eos=True)]
    else:  # shed_on_full
        eng = engine_cls(model, params, max_waiting=2, shed_on_full=True, **dict(kw, n_slots=1))
        reqs = [eng.submit([1, 2, 3], 4, ignore_eos=True) for _ in range(4)]
    for _ in range(40):
        if not eng.scheduler.has_work:
            break
        eng.step()
        clk.t += 1.0 if scenario != "shed_on_full" else 0.1
    return [(r.finish_reason, len(r.output)) for r in reqs], (eng.n_deadline_missed, eng.n_shed)


@pytest.mark.parametrize("scenario", ["deadline", "queue_timeout", "shed_on_full"])
def test_engine_lifecycle_matches_reference(scenario):
    """Deadlines, queue timeouts and shedding end the same requests, at the
    same point, with the same counters as the reference engine."""
    jcfg = jax_configs.reduced_for_smoke(ARCH, vocab_size=128)
    tcfg = configs.reduced_for_smoke(ARCH, vocab_size=128)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    want = _lifecycle(JaxEngine, jm, jp, scenario)
    got = _lifecycle(ContinuousBatchingEngine, tm, params_from_numpy(jax.device_get(jp), tcfg), scenario)
    assert got == want


def test_temperature_sampling_is_seeded():
    cfg = configs.reduced_for_smoke(ARCH, vocab_size=64)
    model = Model(cfg, device="cpu")
    params = model.init(0)

    def serve(seed):
        eng = ContinuousBatchingEngine(
            model, params, n_slots=2, chunk_size=4, max_seq_len=24, temperature=0.8, seed=seed
        )
        reqs = [eng.submit([1 + i, 2, 3], 8, ignore_eos=True) for i in range(3)]
        eng.run()
        return [r.output for r in reqs]

    a, b = serve(0), serve(0)
    assert a == b and all(len(o) == 8 and all(0 <= t < 64 for t in o) for o in a)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced_for_smoke(ARCH, vocab_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "minimind-moe-16e", "--reduced"])
    model = Model(cfg, device="cpu")
    eng = ContinuousBatchingEngine(model, model.init(0), n_slots=2, chunk_size=4, max_seq_len=16)
    assert eng.device.type == "cpu"


def test_serve_cli_on_cpu(capsys, tmp_path):
    import json

    from repro_torch.launch import serve

    tel = tmp_path / "serve.jsonl"
    rc = serve.main([
        "--arch", "minimind-moe-16e", "--reduced", "--device", "cpu",
        "--requests", "3", "--n-slots", "2", "--chunk", "4", "--gen", "3",
        "--prompt-len", "6", "--inject", "slow_step@ms=1", "--telemetry", str(tel),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "served 3 requests over 2 slots" in out and "MaxVio" in out
    assert "slow_step 1 ms" in out
    records = [json.loads(line) for line in tel.read_text().splitlines()]
    assert [r["kind"] for r in records].count("serve_request") == 3
    assert records[-1]["kind"] == "serve_summary"
