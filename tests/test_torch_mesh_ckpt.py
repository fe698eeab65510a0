"""Checkpoints of a sharded state, microbatches on a mesh and the balance
sweep's cross-shard cells, on a 4x2 mesh of 8 gloo ranks beside one
subprocess of the reference on its forced 8-device mesh (the rank bodies:
tests/_torch_mesh_ranks.ckpt_checks).

The one-device references run in ranks 1-4 after the mesh work (one
thread each, side by side), not in the test process.

Contracts. The port's CPU training is bit-reproducible, so a resumed mesh
run is bit-equal to the straight one (losses, params, q, the data cursor)
and the file written on the mesh equals the gathered state bit for bit,
in the reference's reader too. Across decompositions BIP is LP-degenerate
(ROADMAP queue 3, item 2): a one-device run resumed from the mesh's file,
and bip microbatches on the mesh against one device's, are held to the
bounds tests/test_torch_train_mesh.py holds a mesh loop to (losses and q
within 5e-3, per-layer MaxVio within 8 load quanta at any step and 2 on
average). topk microbatches follow the reference's anchor
(tests/test_train_sharded.py:494-496: loss 1e-5, params 1e-4 against
micro 1) and, against the reference's sharded microbatched step from the
same state and one device's, the loss within 1e-5 relative, the step's
update within 1e-4 per element and AdamW's first moment within 1e-4
relative (MICRO_*).
The sweep's 2-step cells on the mesh against the reference's
`_run_method(..., sync=, mesh_shape=(4, 2))`: per-layer MaxVio within one
load quantum, perplexity within 1e-3 relative.
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
from _torch_mesh_ranks import (  # noqa: E402
    CKPT_AT, CKPT_STEPS, ROLLBACK_NAN, ckpt_checks, micro_cfg, train_cfg,
)
from _torch_mesh_util import alongside, run_ranks  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import store as jax_store  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import SyntheticBatchStream  # noqa: E402
from repro_torch.launch import balance_sweep  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REF = r"""
import pickle
from benchmarks import balance_sweep as ref_sweep
from repro import configs
from repro.data import make_batches
from repro.distributed import make_mesh_ctx, shard_tree, train_state_specs
from repro.models import build_model
from repro.optim.adamw import from_model_config
from repro.optim.schedules import constant
from repro.training import compile_train_step
from repro.training.loop import TrainState

with open(WD + "/micro_state.pkl", "rb") as f:
    micro_state = pickle.load(f)
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
cfg = configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256)
cfg = dataclasses.replace(cfg, routing=dataclasses.replace(cfg.routing, strategy="topk", capacity_factor=8.0))
model = build_model(cfg, make_mesh_ctx(mesh))
opt = from_model_config(cfg)
batch = next(iter(make_batches(cfg, 8, 32, 1, seed=0)))
state = TrainState(*jax.tree.map(jnp.asarray, micro_state))
st = shard_tree(state, train_state_specs(state, cfg, mesh), mesh)
fn = compile_train_step(model, opt, constant(1e-3), st, batch, mesh=mesh, microbatches=2)
with mesh:
    s_new, mets = fn(st, batch)
out = {"micro_loss": float(mets["loss"]), "micro_params": jax.device_get(s_new.params),
       "micro_mu": jax.device_get(s_new.opt_state["mu"])}
scfg = ref_sweep._sweep_cfg("minimind_moe_16e")
for sync in ("global", "local"):
    out["sweep_" + sync] = ref_sweep._run_method(scfg, "bip", 2, lr=1e-3, sync=sync, mesh_shape=(4, 2))
with open(WD + "/ref.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


# the microbatched sharded step against the reference's and one device's
# (fp32): loss relative, the update per element (the reference anchor's
# micro bound, tests/test_train_sharded.py:496), the first moment relative
MICRO_LOSS_RTOL, MICRO_UPDATE_TOL, MICRO_MU_RTOL = 1e-5, 1e-4, 1e-4


def _ref_init(jcfg):
    jm = jax_build_model(jcfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jax_adamw.from_model_config(jcfg))
    return tuple(jax.device_get((js.params, js.opt_state, js.router_states)))


@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_ckpt")
    from benchmarks import balance_sweep as ref_sweep

    for name, jcfg in (("micro_state", micro_cfg(jax_configs)),
                       ("sweep_state", ref_sweep._sweep_cfg("minimind_moe_16e"))):
        with open(wd / f"{name}.pkl", "wb") as f:
            pickle.dump(_ref_init(jcfg), f)
    ranks = alongside(PRELUDE + f"WD = {str(wd)!r}\n" + REF, lambda: run_ranks(ckpt_checks, 8, wd))
    with open(wd / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return wd, ranks, ref


def _close_loops(got, other, cfg, rows=8, seq=64):
    """The mesh-loop bounds of tests/test_torch_train_mesh.py."""
    quantum = 1.0 / (rows * seq * cfg.routing.top_k / cfg.routing.n_experts)
    assert len(got["losses"]) == len(other["losses"])
    assert np.abs(np.subtract(got["losses"], other["losses"])).max() < 5e-3
    assert np.abs(got["q"] - other["q"]).max() < 5e-3
    dstep = np.abs(got["vio"] - other["vio"]).max(axis=1)
    assert dstep.max() <= 8 * quantum + 1e-5 and dstep.mean() <= 2 * quantum + 1e-5, dstep


def test_mesh_resume_is_bit_equal_to_the_straight_run(ckpt_run):
    """4 steps straight against 2 with a save at step 2 and a resume from it
    (bip, sync='global'): losses, every param, q bit-equal on every rank,
    and the cursor saved beside the file is the stream's after 2 steps."""
    wd, ranks, _ = ckpt_run
    for r in ranks:
        a, b = r["straight"], r["resumed"]
        assert a["losses"] == b["losses"] == ranks[0]["straight"]["losses"]
        np.testing.assert_array_equal(a["q"], b["q"])
        assert a["params"].keys() == b["params"].keys()
        for path in a["params"]:
            np.testing.assert_array_equal(a["params"][path], b["params"][path], err_msg=path)
    stream = SyntheticBatchStream(train_cfg(configs, sync_global=True), 8, 64, CKPT_STEPS, seed=0)
    it = iter(stream)
    for _ in range(CKPT_AT):
        next(it)
    with open(wd / "ck" / f"step_{CKPT_AT}.data.json") as f:
        assert json.load(f) == json.loads(json.dumps(stream.state_dict()))


def test_mesh_file_reads_in_the_reference_and_resumes_on_one_device(ckpt_run):
    """The step-2 file written by the mesh run: the reference's
    load_pytree(verify=True) reads it and every leaf equals the state
    gathered from the ranks bit for bit; one device resumed from it (rank
    1, alone, after the mesh work) tracks the mesh's resumed steps within
    the mesh-loop bounds."""
    wd, ranks, _ = ckpt_run
    path = wd / "ck" / f"step_{CKPT_AT}.npz"
    tree = jax_store._flatten(jax_store.load_pytree(str(path), verify=True))
    saved = ranks[0]["saved"]
    assert tree.keys() == saved.keys()
    for key, want in saved.items():
        got = tree[key]
        if want is None:
            assert got is None, key
            continue
        got = np.asarray(got)
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    mesh = dict(ranks[0]["resumed"], losses=ranks[0]["resumed"]["losses"][CKPT_AT:],
                vio=ranks[0]["resumed"]["vio"][-(CKPT_STEPS - CKPT_AT):])
    _close_loops(ranks[1]["one_device"], mesh, train_cfg(configs, sync_global=True))


def test_rollback_on_the_mesh(ckpt_run):
    """A guarded mesh run with nan_grad@step=3 under the rollback policy:
    every rank takes the same decisions, restores step 2's checkpoint and
    replays with the bad step skipped, ending where one device's same
    guarded run (rank 2, alone) ends (the mesh-loop bounds)."""
    _, ranks, _ = ckpt_run
    got = ranks[0]["rollback"]
    kinds = [(e["step"], e["kind"]) for e in got["events"]]
    for r in ranks[1:]:  # (the non-finite event's loss is NaN: compare steps and kinds)
        assert [(e["step"], e["kind"]) for e in r["rollback"]["events"]] == kinds
        assert r["rollback"]["losses"] == got["losses"]
    assert (ROLLBACK_NAN, "rollback") in kinds and (ROLLBACK_NAN, "forced_skip") in kinds, kinds
    one = ranks[2]["one_device"]
    assert [(e["step"], e["kind"]) for e in one["events"]] == kinds
    _close_loops(got, one, train_cfg(configs, sync_global=True))


@pytest.mark.parametrize("rows", [8, 4])
def test_topk_microbatches_on_the_mesh(ckpt_run, rows):
    """topk at capacity factor 8: two microbatches against one on the mesh,
    the reference anchor's bounds (loss 1e-5, params 1e-4). At 8 rows each
    microbatch splits over the 4 data ranks; at 4 rows its 2 rows do not,
    and batch_specs' rule replicates them (each rank the whole microbatch)."""
    _, ranks, _ = ckpt_run
    one, two = ranks[0][f"micro_{rows}_1"], ranks[0][f"micro_{rows}_2"]
    assert two["split"] == (rows == 8)
    assert abs(one["loss"] - two["loss"]) < 1e-5, (one["loss"], two["loss"])
    for path, v in two["params"].items():
        np.testing.assert_allclose(v, one["params"][path], atol=1e-4, rtol=1e-4, err_msg=path)


def _by_path(tree, cfg):
    """A reference params-shaped tree as the port's {path: array}."""
    return {p: v.numpy() for p, v in adamw.tree_paths(params_from_numpy(tree, cfg, "cpu"))}


def test_microbatches_on_the_mesh_match_the_reference(ckpt_run):
    """The port's microbatched sharded step (2 microbatches, topk, fp32)
    against the reference's compile_train_step(mesh=, microbatches=2) from
    the same converted state, and against the port's one-device
    microbatched step (rank 4, alone). The loss within MICRO_LOSS_RTOL
    relative. The step's update (params after less params before) within
    MICRO_UPDATE_TOL of theirs per element: AdamW moves an element by
    about lr = 1e-3, so a step with no update fails. AdamW's first moment
    after one step ((1 - b1) times the clipped gradient) within
    MICRO_MU_RTOL relative L2 per leaf: Adam's first update is nearly
    blind to the gradient's scale, this is not, so a halved or zeroed
    gradient fails."""
    wd, ranks, ref = ckpt_run
    got, one = ranks[0]["micro_8_2"], ranks[4]["one_device"]
    cfg = micro_cfg(configs)
    with open(wd / "micro_state.pkl", "rb") as f:
        before = _by_path(pickle.load(f)[0], cfg)
    reference = {"loss": ref["micro_loss"], "params": _by_path(ref["micro_params"], cfg),
                 "mu": _by_path(ref["micro_mu"], cfg)}
    for want in (reference, one):
        assert abs(got["loss"] - want["loss"]) / abs(want["loss"]) < MICRO_LOSS_RTOL, (got["loss"], want["loss"])
        assert got["params"].keys() == want["params"].keys() == before.keys() == got["mu"].keys()
        for path, v in got["params"].items():
            np.testing.assert_allclose(v - before[path], want["params"][path] - before[path],
                                       atol=MICRO_UPDATE_TOL, rtol=0, err_msg=path)
            mu, want_mu = got["mu"][path], want["mu"][path]
            assert np.linalg.norm(mu - want_mu) <= MICRO_MU_RTOL * np.linalg.norm(want_mu), path


def test_bip_microbatches_on_the_mesh_track_one_device(ckpt_run):
    """bip (sync='global', capacity factor 8) with two microbatches, two
    steps on the mesh against one device's (rank 3, alone): the BIP duals
    thread through the same global microbatches in the same order, so q,
    the losses and MaxVio stay within the mesh-loop bounds."""
    _, ranks, _ = ckpt_run
    for r in ranks[1:]:
        assert r["micro_bip"]["losses"] == ranks[0]["micro_bip"]["losses"]
    _close_loops(ranks[0]["micro_bip"], ranks[3]["one_device"], train_cfg(configs, sync_global=True))


@pytest.mark.parametrize("sync", ["global", "local"])
def test_sweep_sync_cells_match_the_reference(ckpt_run, sync):
    """balance_sweep.run_method on the 4x2 mesh (bip, the threshold solver)
    against benchmarks.balance_sweep._run_method(..., sync=, mesh_shape=
    (4, 2)) from the same init, 2 steps: the record names its sync mode
    and mesh, per-layer MaxVio within one load quantum, perplexity within
    1e-3 relative."""
    _, ranks, ref = ckpt_run
    got, want = ranks[0][f"sweep_{sync}"], ref[f"sweep_{sync}"]
    assert got["sync"] == want["sync"] == sync and got["mesh"] == want["mesh"] == [4, 2]
    cfg = balance_sweep.sweep_cfg("minimind_moe_16e")
    quantum = 1.0 / (balance_sweep.BATCH * balance_sweep.SEQ_LEN * cfg.routing.top_k / cfg.routing.n_experts)
    vio = np.abs(np.subtract(got["max_vio_per_step"], want["max_vio_per_step"]))
    assert vio.max() <= quantum + 1e-5, vio
    np.testing.assert_allclose(got["ppl_per_step"], want["ppl_per_step"], rtol=1e-3)


def test_train_cli_checkpoints_and_microbatches_on_a_mesh(tmp_path):
    """`launch.train --mesh 2x2 --micro 2 --ckpt-dir d --ckpt-every 2` for 4
    steps under torch.distributed.run, then, with step 4's files removed,
    `--resume`: the resumed steps 2-3 print the first run's losses."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"), OMP_NUM_THREADS="1")
    ck = tmp_path / "ck"
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
            "-m", "repro_torch.launch.train", "--arch", "minimind-moe-16e", "--device", "cpu", "--reduced",
            "--steps", "4", "--batch", "4", "--seq-len", "32", "--mesh", "2x2", "--micro", "2",
            "--sync", "global", "--ckpt-dir", str(ck), "--ckpt-every", "2", "--log-every", "1"]
    runs = []
    for extra, name in (([], "a.json"), (["--resume"], "b.json")):
        res = subprocess.run(base + extra + ["--out-json", str(tmp_path / name)], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
        runs.append(json.loads((tmp_path / name).read_text()))
        if not extra:
            for f in ck.glob("step_4.*"):
                f.unlink()
    first, resumed = runs
    assert first["mesh"] == {"data": 2, "model": 2} and first["microbatches"] == 2
    assert resumed["losses"] == first["losses"][2:]
