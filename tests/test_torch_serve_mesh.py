"""The port's engine on a device mesh against the reference's mesh engine
(tests/test_serving_mesh.py:71) and the port's one-device engine, with the
reference test's own setup: reduced minimind-16e, vocab 128, sync='global',
capacity factor 4, 4 slots x chunk 8, max_seq_len 64, six seeded prompts
of 5 tokens each, a 4x2 mesh (8 gloo ranks; the reference on its forced
8-device mesh in one subprocess beside them), all from the reference's
params (converted).

Contract (the reference's): topk is score-deterministic, so tokens and
per-expert loads are bit-equal; under bip the sharded trunk's
reassociation flips LP-degenerate tokens, so tokens equal, load totals
equal and an L1 drift of at most 8 (ROADMAP queue 3, item 2). A packed
case spreads a prompt of more than two chunks onto rows whose slots other
data ranks hold: the plan is the reference mesh engine's at every step
and the tokens the one-device packed engine's.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _forced_devices import PRELUDE, REPO_ROOT  # noqa: E402
from _torch_mesh_ranks import (  # noqa: E402
    SERVE_STRATEGIES, formerly_refused, serve_cfg, serve_checks, serve_prompts, serve_small, serve_stream,
)
from _torch_mesh_util import alongside, run_ranks  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402

REF = r"""
import pickle
sys.path.insert(0, "tests")
from repro import configs
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.serving import ContinuousBatchingEngine
from _torch_mesh_ranks import SERVE_STRATEGIES, serve_cfg, serve_prompts, serve_stream

with open(WD + "/serve_params.pkl", "rb") as f:
    params = jax.tree.map(jnp.asarray, pickle.load(f))
mesh = make_host_mesh(4, 2)
out = {}
for strategy in SERVE_STRATEGIES:
    model = build_model(serve_cfg(configs, strategy))
    out[strategy] = serve_stream(ContinuousBatchingEngine, model, params, serve_prompts(), 5, mesh)[:2]
model = build_model(serve_cfg(configs, "topk"))
out["packed"] = serve_stream(ContinuousBatchingEngine, model, params, serve_prompts(True), 4, mesh, plans=True)
with open(WD + "/ref.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("serve_mesh")
    jcfg = serve_cfg(jax_configs, "topk")
    tree = jax.device_get(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    with open(wd / "serve_params.pkl", "wb") as f:
        pickle.dump(tree, f)
    ranks = alongside(PRELUDE + f"WD = {str(wd)!r}\n" + REF, lambda: run_ranks(serve_checks, 8, wd))
    with open(wd / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    single = {}
    for strategy in SERVE_STRATEGIES:
        cfg = serve_cfg(configs, strategy)
        single[strategy] = serve_stream(ContinuousBatchingEngine, Model(cfg, device="cpu"),
                                        params_from_numpy(tree, cfg, "cpu"), serve_prompts(), 5)[:2]
    cfg = serve_cfg(configs, "topk")
    single["packed"] = serve_stream(ContinuousBatchingEngine, Model(cfg, device="cpu"),
                                    params_from_numpy(tree, cfg, "cpu"), serve_prompts(True), 4, plans=True)
    return ranks, ref, single


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert r[key][0] == ranks[0][key][0]
        np.testing.assert_array_equal(r[key][1], ranks[0][key][1])


def test_topk_serving_on_mesh_is_bit_equal(serve_run):
    """topk: every rank samples the same tokens; tokens and per-expert loads
    equal the reference's mesh engine and the port's one-device engine."""
    ranks, ref, single = serve_run
    _same_on_every_rank(ranks, "topk")
    tokens, load = ranks[0]["topk"]
    assert tokens == ref["topk"][0] == single["topk"][0]
    np.testing.assert_array_equal(load, np.asarray(ref["topk"][1]))
    np.testing.assert_array_equal(load, single["topk"][1])


def test_bip_serving_on_mesh_within_degeneracy(serve_run):
    """bip (sync='global', the masked global dual on the mesh): tokens
    equal, load totals equal, L1 drift of the per-expert loads <= 8 against
    the reference's mesh engine and the port's one-device engine."""
    ranks, ref, single = serve_run
    _same_on_every_rank(ranks, "bip")
    tokens, load = ranks[0]["bip"]
    for other_tokens, other_load in (ref["bip"], single["bip"]):
        other_load = np.asarray(other_load)
        assert tokens == other_tokens
        assert load.sum() == other_load.sum()
        assert float(np.abs(load - other_load).sum()) <= 8.0, (load, other_load)


def test_packed_step_spreads_onto_rows_of_other_data_ranks(serve_run):
    """A prompt of 21 tokens (more than two chunks of 8) beside two short
    ones: its chunks spread onto rows whose slots other data ranks hold (4
    slots on 4 data ranks: one each), the plan equals the reference mesh
    engine's and the one-device engine's at every step, and the tokens are
    the one-device packed engine's on every rank."""
    ranks, ref, single = serve_run
    _same_on_every_rank(ranks, "packed")
    tokens, load, plans = ranks[0]["packed"]
    assert len(plans) == len(ref["packed"][2]) == len(single["packed"][2])
    for step, (got, want, one) in enumerate(zip(plans, ref["packed"][2], single["packed"][2])):
        assert (got is None) == (want is None) == (one is None), step
        if got is not None:
            for a, b, c in zip(got, want, one):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"step {step}")
                np.testing.assert_array_equal(a, c, err_msg=f"step {step}")
    spread = [p for p in plans if p is not None and (p[4] != np.arange(4)).any()]  # cache_rows
    assert spread, "no step spread a prompt onto another slot's row"
    assert tokens == ref["packed"][0] == single["packed"][0]
    np.testing.assert_array_equal(load, single["packed"][1])


def test_mesh_serving_refusals(serve_run):
    """The two setups mesh serving once refused now serve on the 4x2 mesh
    like one device: a stack with SSM/conv state (reduced mamba2-130m, 4
    slots) and 6 slots over 4 data ranks (topk minimind; the cache splits
    its length): every rank the same tokens, and tokens and loads equal to
    the one-device engine on the same params."""
    ranks, _, _ = serve_run
    for name, cfg, n_slots in formerly_refused(configs):
        model = Model(cfg, device="cpu")
        tokens, load = serve_small(ContinuousBatchingEngine, model, model.init(0), n_slots)
        for r in ranks:
            assert r["refusals"][name][0] == tokens, name
            np.testing.assert_array_equal(r["refusals"][name][1], load)


def test_serve_cli_on_mesh_under_torchrun(tmp_path):
    """`launch.serve --mesh 2x2 --device cpu --reduced` under
    torch.distributed.run (4 gloo ranks) serves every request and prints
    once; without the launcher --mesh is an argparse error."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"), OMP_NUM_THREADS="1")
    args = ["--arch", "minimind-moe-16e", "--device", "cpu", "--reduced", "--requests", "6", "--n-slots", "4",
            "--chunk", "8", "--gen", "4", "--prompt-len", "20"]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.serve", *args, "--mesh", "2x2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert res.stdout.count("serving on a 2x2 mesh (4 ranks over gloo)") == 1
    assert res.stdout.count("served 6 requests over 4 slots") == 1
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(args + ["--mesh", "2x2"])
