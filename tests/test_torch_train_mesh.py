"""The port's sharded training against the reference's: one train step of
the reduced minimind-16e on a 4x2 mesh from a TrainState converted from
the reference's (test_distributed.py:11), train_loop(mesh=) under
sync='global' (test_train_sharded.py:209, 336), and the launcher's --mesh
under torch.distributed.run.

The reference's initial states and its single-device step run here; its
sharded step and loop run in one subprocess on the forced 8-device mesh,
beside eight gloo ranks of the port (tests/_torch_mesh_ranks.train_checks).
Tolerances are the reference anchors': the sharded step's loss within 2e-2
relative and every param within 5e-2 of the single-device step; the
sync='global' loop within the bounds the reference holds its own mesh run
to (losses 5e-3, q 5e-3, per-layer MaxVio within 8 load quanta at any step
and 2 on average), since a few capacity-marginal tokens flip between
decompositions of the trunk's fp32 sums (ROADMAP queue 3, item 2).
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _forced_devices import PRELUDE, REPO_ROOT  # noqa: E402
from _torch_mesh_ranks import train_cfg, train_checks  # noqa: E402
from _torch_mesh_util import alongside, run_ranks  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.data import make_batches as jax_make_batches  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.training import make_train_step, train_loop  # noqa: E402

IMPLS = ("ep", "ep2d", "ep2ds")
LOOP_STEPS = 3

REF = r"""
import pickle
from repro import configs
from repro.data import make_batches
from repro.distributed import batch_specs, make_mesh_ctx, shard_tree, train_state_specs
from repro.models import build_model
from repro.optim.adamw import from_model_config
from repro.optim.schedules import constant
from repro.training import make_train_step, train_loop
from repro.training.loop import TrainState

with open(WD + "/jax_states.pkl", "rb") as f:
    states = pickle.load(f)
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
out = {}

cfg = configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256)
model = build_model(cfg, make_mesh_ctx(mesh))
state = TrainState(*jax.tree.map(jnp.asarray, states["step"]))
specs = train_state_specs(state, cfg, mesh)
state = shard_tree(state, specs, mesh)
batch = next(iter(make_batches(cfg, 8, 64, 1, seed=0)))
bs = batch_specs(cfg, mesh, 8)
batch = shard_tree(batch, {k: bs[k] for k in batch}, mesh)
with mesh:
    s1, m1 = jax.jit(make_train_step(model, from_model_config(cfg), constant(1e-3)))(state, batch)
out["step_loss"] = float(m1["loss"])
out["step_params"] = jax.device_get(s1.params)

full = configs.get("minimind_moe_16e")
cfg = configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256, routing=dataclasses.replace(
    full.routing, sync="global", capacity_factor=8.0))
state = TrainState(*jax.tree.map(jnp.asarray, states["loop"]))
st, log = train_loop(build_model(cfg, make_mesh_ctx(mesh)), make_batches(cfg, 8, 64, STEPS, seed=0),
                     lr=1e-3, warmup_steps=2, total_steps=STEPS, state=state, mesh=mesh)
out["loop_losses"] = list(log.losses)
out["loop_vio"] = np.stack(log.max_vio_steps)
out["loop_q"] = np.concatenate([np.asarray(jax.device_get(s["q"])).ravel()
                                for s in st.router_states if s is not None])
with open(WD + "/ref.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _jax_state(jcfg):
    jm = jax_build_model(jcfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jax_adamw.from_model_config(jcfg))
    return jm, js, tuple(jax.device_get((js.params, js.opt_state, js.router_states)))


def _jax_cfgs():
    full = jax_configs.get("minimind_moe_16e")
    import dataclasses

    return (jax_configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256),
            jax_configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256, routing=dataclasses.replace(
                full.routing, sync="global", capacity_factor=8.0)))


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("train_mesh")
    jcfg_step, jcfg_loop = _jax_cfgs()
    jm, js, step_state = _jax_state(jcfg_step)
    _, _, loop_state = _jax_state(jcfg_loop)
    with open(wd / "jax_states.pkl", "wb") as f:
        pickle.dump({"step": step_state, "loop": loop_state}, f)
    with open(wd / "state.pkl", "wb") as f:  # the ranks' share: numpy trees only
        pickle.dump(step_state, f)
    with open(wd / "loop_state.pkl", "wb") as f:
        pickle.dump(loop_state, f)
    code = PRELUDE + f"WD = {str(wd)!r}\nSTEPS = {LOOP_STEPS}\n" + REF
    ranks = alongside(code, lambda: run_ranks(train_checks, 8, wd, IMPLS, LOOP_STEPS))
    with open(wd / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    # the reference's single-device step, here
    batch = next(iter(jax_make_batches(jcfg_step, 8, 64, 1, seed=0)))
    opt = jax_adamw.from_model_config(jcfg_step)
    s0, m0 = jax.jit(jax_loop.make_train_step(jm, opt, jax_schedules.constant(1e-3)))(js, batch)
    single = {"loss": float(m0["loss"]), "params": jax.device_get(s0.params)}
    return ranks, ref, single, step_state, loop_state


def _port_paths(params_tree, cfg):
    return {p: v.numpy() for p, v in adamw.tree_paths(params_from_numpy(params_tree, cfg, "cpu"))}


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_step_matches_single_device(train_run, impl):
    """One step on the 4x2 mesh through each EP path: loss within 2e-2
    relative and every param within 5e-2 of the reference's single-device
    step, of its sharded step, and of the port's single-device step, from
    one converted TrainState; every rank returns the same loss, and the
    gradient norm (summed over the ranks' blocks) is the port's
    single-device one within 2e-2 (AdamW's first update is the gradient's
    sign, so the params alone would not see a gradient off by a factor)."""
    ranks, ref, single, step_state, _ = train_run
    cfg = train_cfg(configs, impl=impl)
    model = Model(cfg, device="cpu")
    state = train_state_from_numpy(*step_state, cfg, "cpu")
    step = make_train_step(model, adamw.from_model_config(cfg), schedules.constant(1e-3))
    state, mets = step(state, next(iter(make_batches(cfg, 8, 64, 1, seed=0))))
    port_single = {p: v.detach().numpy() for p, v in adamw.tree_paths(state.params)}
    got = ranks[0][f"step_{impl}_params"]
    loss = ranks[0][f"step_{impl}_loss"]
    assert all(r[f"step_{impl}_loss"] == loss for r in ranks)
    gn = float(mets["grad_norm"])
    assert abs(ranks[0][f"step_{impl}_grad_norm"] - gn) / gn < 2e-2, (ranks[0][f"step_{impl}_grad_norm"], gn)
    for other_loss, other in ((single["loss"], _port_paths(single["params"], cfg)),
                              (ref["step_loss"], _port_paths(ref["step_params"], cfg)),
                              (float(mets["loss"]), port_single)):
        assert abs(loss - other_loss) / abs(other_loss) < 2e-2, (loss, other_loss)
        assert got.keys() == other.keys()
        for path, v in got.items():
            np.testing.assert_allclose(v, other[path], atol=5e-2, rtol=5e-2, err_msg=path)


@pytest.mark.parametrize("impl", IMPLS)
def test_replicated_batch_step_matches_single_device(train_run, impl):
    """A batch of 2 rows on 4 data ranks does not split (batch_specs
    replicates it): every rank takes the whole batch, the EP paths cut the
    tokens to the rank's rows inside the MoE layer where they split (ep,
    ep2ds) and gather the output back, and the step still matches the
    single-device step (loss 2e-2 relative, params 5e-2: the anchors'
    bounds, since each path's capacity comes from its own token count), the
    gradient norm within 2e-2."""
    ranks, _, _, step_state, _ = train_run
    cfg = train_cfg(configs, impl=impl)
    model = Model(cfg, device="cpu")
    step = make_train_step(model, adamw.from_model_config(cfg), schedules.constant(1e-3))
    state, mets = step(train_state_from_numpy(*step_state, cfg, "cpu"),
                       next(iter(make_batches(cfg, 2, 64, 1, seed=0))))
    want = {p: v.detach().numpy() for p, v in adamw.tree_paths(state.params)}
    got, loss = ranks[0][f"small_{impl}_params"], ranks[0][f"small_{impl}_loss"]
    assert all(r[f"small_{impl}_loss"] == loss for r in ranks)
    assert abs(loss - float(mets["loss"])) / abs(float(mets["loss"])) < 2e-2
    gn = float(mets["grad_norm"])
    assert abs(ranks[0][f"small_{impl}_grad_norm"] - gn) / gn < 2e-2, (ranks[0][f"small_{impl}_grad_norm"], gn)
    assert got.keys() == want.keys()
    for path, v in got.items():
        np.testing.assert_allclose(v, want[path], atol=5e-2, rtol=5e-2, err_msg=path)


def test_global_sync_train_loop_tracks_reference(train_run):
    """train_loop(mesh=) under sync='global' (16 experts top-4, capacity
    factor 8) tracks the reference's mesh run and the port's single-device
    run over the steps: losses within 5e-3, final q within 5e-3, per-layer
    MaxVio within 8 quanta at any step and 2 on average."""
    ranks, ref, _, _, loop_state = train_run
    cfg = train_cfg(configs, sync_global=True)
    st, log = train_loop(Model(cfg, device="cpu"), make_batches(cfg, 8, 64, LOOP_STEPS, seed=0), lr=1e-3,
                         warmup_steps=2, total_steps=LOOP_STEPS,
                         state=train_state_from_numpy(*loop_state, cfg, "cpu"))
    single = {"loop_losses": log.losses, "loop_vio": np.stack(log.max_vio_steps),
              "loop_q": np.concatenate([s["q"].numpy() for s in st.router_states if s is not None])}
    got = ranks[0]
    quantum = 1.0 / (8 * 64 * cfg.routing.top_k / cfg.routing.n_experts)
    for other in (ref, single):
        assert len(got["loop_losses"]) == len(other["loop_losses"]) == LOOP_STEPS
        assert np.abs(np.subtract(got["loop_losses"], other["loop_losses"])).max() < 5e-3
        assert np.abs(got["loop_q"] - other["loop_q"]).max() < 5e-3
        dstep = np.abs(got["loop_vio"] - other["loop_vio"]).max(axis=1)
        assert dstep.max() <= 8 * quantum + 1e-5 and dstep.mean() <= 2 * quantum + 1e-5, dstep
    for r in ranks[1:]:
        assert r["loop_losses"] == got["loop_losses"]
        np.testing.assert_array_equal(r["loop_q"], got["loop_q"])


def test_launcher_mesh_runs_under_torchrun(tmp_path):
    """`launch.train --mesh 2x2 --device cpu --reduced --steps 2` under
    torch.distributed.run (4 ranks, gloo) writes the summary JSON with the
    single-device run's keys, and trains."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"), OMP_NUM_THREADS="1")
    common = ["--arch", "minimind-moe-16e", "--device", "cpu", "--reduced", "--steps", "2", "--batch", "4",
              "--seq-len", "32", "--log-every", "1"]
    mesh_json = tmp_path / "mesh.json"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", *common, "--mesh", "2x2", "--sync", "global",
         "--out-json", str(mesh_json)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    single_json = tmp_path / "single.json"
    res1 = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *common,
                           "--out-json", str(single_json)],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res1.returncode == 0, res1.stderr[-3000:]
    mesh_sum, single_sum = json.loads(mesh_json.read_text()), json.loads(single_json.read_text())
    assert mesh_sum.keys() == single_sum.keys()
    assert mesh_sum["mesh"] == {"data": 2, "model": 2} and single_sum["mesh"] is None
    assert len(mesh_sum["losses"]) == 2 and all(np.isfinite(mesh_sum["losses"]))
