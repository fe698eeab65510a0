"""Port vs reference: checkpoints in the reference's npz format.

A file written by either package restores in the other, leaf for leaf:
the same '|'-joined paths, dtypes (bf16 as a uint16 view, the optimizer's
step as a 0-d int32, None leaves as the reference encodes them) and
crc32s; the port's per-layer TrainState is stacked back into the
reference's per-position group layout on save and unstacked on restore.

Contracts: leaves compare BITWISE (a checkpoint stores bits). Two train
steps after a cross-package restore follow tests/test_torch_train.py's
contract: lossfree losses rtol 1e-5, grad norm rtol 1e-3, router states
atol 1e-7; bip on the kernel path losses rtol 1e-4, q atol 0.01 (BIP's
capacity boundary is LP-degenerate, ROADMAP.md queue 3).
"""
from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import store as jax_store  # noqa: E402
from repro.data import make_batches as jax_make_batches  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import schedules as jax_schedules  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
    CheckpointManager,
    checkpoint_steps,
    load_pytree,
    save_pytree,
    verify_checkpoint,
)
from repro_torch.checkpoint.store import write_manifest  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    router_states_from_numpy,
    train_state_from_numpy,
    train_state_to_tree,
)
from repro_torch.data import SyntheticBatchStream, make_batches  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.robustness import FaultPlan, corrupt_file  # noqa: E402
from repro_torch.training import init_train_state, make_train_step, train_loop  # noqa: E402

ARCH = "minimind_moe_16e"


def _cfgs(strategy, use_kernel=False, **kw):
    """Reduced minimind-16e with the full routing table (16 experts top-4)."""
    jfull, tfull = jax_configs.get(ARCH), configs.get(ARCH)
    jr = dataclasses.replace(jfull.routing, strategy=strategy, use_kernel=use_kernel)
    tr = dataclasses.replace(tfull.routing, strategy=strategy, use_kernel=use_kernel)
    return (
        jax_configs.reduced_for_smoke(ARCH, routing=jr, vocab_size=128, **kw),
        configs.reduced_for_smoke(ARCH, routing=tr, vocab_size=128, **kw),
    )


def _bits(x) -> np.ndarray:
    """A leaf's stored bits: bf16 as uint16, everything else as is."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _leaves(tree):
    """(path, leaf) pairs in the npz's flattening order."""
    return list(jax_store._flatten(tree).items())


def _assert_trees_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None, path
            continue
        bx, by = _bits(x), _bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape, path
        np.testing.assert_array_equal(bx, by, err_msg=path)


def _state_leaves(ts):
    return _leaves({"p": ts.params, "mu": ts.opt_state["mu"], "nu": ts.opt_state["nu"],
                    "r": ts.router_states})


# ------------------------------------------------------------- the format


def test_trees_roundtrip_across_packages(tmp_path):
    """bf16, a 0-d int32, None leaves, a tuple and a list, written by each
    package and read by the other: the same leaves, bit for bit."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    tree_t = {
        "w": torch.from_numpy(w),
        "h": torch.from_numpy(w).to(torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
        "states": [None, {"q": torch.arange(4, dtype=torch.float32)}],
        "pair": (torch.ones(2, dtype=torch.int32), None),
    }
    tree_j = {
        "w": jnp.asarray(w), "h": jnp.asarray(w, jnp.bfloat16), "step": jnp.int32(7),
        "states": [None, {"q": jnp.arange(4, dtype=jnp.float32)}],
        "pair": (jnp.ones(2, jnp.int32), None),
    }
    save_pytree(str(tmp_path / "port.npz"), tree_t)
    jax_store.save_pytree(str(tmp_path / "ref.npz"), tree_j)
    from_port = jax_store.load_pytree(str(tmp_path / "port.npz"), verify=True)
    from_ref = load_pytree(str(tmp_path / "ref.npz"), verify=True)
    assert isinstance(from_ref["pair"], tuple) and isinstance(from_port["pair"], tuple)
    assert from_ref["h"].dtype == torch.bfloat16 and from_ref["step"].dtype == torch.int32
    _assert_trees_bit_equal(from_ref, tree_t)
    _assert_trees_bit_equal(from_port, tree_j)
    # the same meta: paths, dtypes and crc32s
    with np.load(str(tmp_path / "port.npz")) as zt, np.load(str(tmp_path / "ref.npz")) as zj:
        assert bytes(zt["__meta__"]) == bytes(zj["__meta__"])


def test_crc_and_manifest_detect_corruption_in_both_packages(tmp_path):
    for mode in ("bitflip", "truncate"):
        path = str(tmp_path / f"{mode}.npz")
        save_pytree(path, {"w": torch.randn(64, 32), "b": torch.zeros(3)})
        write_manifest(path)
        assert verify_checkpoint(path, deep=True) and jax_store.verify_checkpoint(path, deep=True)
        corrupt_file(path, mode=mode)
        assert not verify_checkpoint(path, deep=True)
        assert not jax_store.verify_checkpoint(path, deep=True)


def test_restore_falls_back_to_newest_valid_and_gc_keeps_valid(tmp_path):
    trees = {s: {"w": torch.full((4, 4), float(s))} for s in (1, 2, 3, 4)}
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (1, 2):
        mgr.save(s, trees[s])
    corrupt_file(os.path.join(mgr.dir, "step_2.npz"), mode="bitflip")
    mgr.save(3, trees[3])  # gc: the corrupt step 2 does not count as kept
    assert checkpoint_steps(mgr.dir) == [1, 2, 3]
    corrupt_file(os.path.join(mgr.dir, "step_3.npz"), mode="truncate")
    with pytest.warns(UserWarning, match="falling back"):
        step, tree = mgr.restore()
    assert step == 1 and torch.equal(tree["w"], trees[1]["w"])
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(step=3)  # an explicit step never falls back


# --------------------------------------------------------- train states


def _ref_state_after_one_step(strategy, use_kernel=False, **kw):
    jcfg, tcfg = _cfgs(strategy, use_kernel, **kw)
    jm, tm = jax_build_model(jcfg), Model(tcfg, device="cpu")
    jopt = jax_adamw.from_model_config(jm.cfg)
    js = jax_loop.init_train_state(jm, jax.random.PRNGKey(0), jopt)
    jstep = jax.jit(jax_loop.make_train_step(
        jm, jopt, jax_schedules.linear_warmup_cosine(1e-3, 1, 10)))
    batches = list(jax_make_batches(jm.cfg, 4, 32, 3))
    js, _ = jstep(js, batches[0])
    return jm, tm, js, jstep, batches


@pytest.mark.parametrize("strategy,use_kernel", [("lossfree", False), ("bip", True)])
def test_reference_checkpoint_restores_in_port_and_trains_on(strategy, use_kernel, tmp_path):
    """A TrainState saved by the reference's CheckpointManager (after one
    step, so the moments are live) restores in the port bit-equal to the
    converted state; two more steps of both packages then agree."""
    jm, tm, js, jstep, batches = _ref_state_after_one_step(strategy, use_kernel)
    d = str(tmp_path / "ck")
    jax_store.CheckpointManager(d).save_train_state(js, data_state={"step": 1})
    step, ts = CheckpointManager(d).restore_train_state(tm.cfg)
    assert step == 1 and ts.opt_state["step"] == 1
    assert CheckpointManager(d).restore_data_state() == {"step": 1}
    want = train_state_from_numpy(jax.device_get(js.params), jax.device_get(js.opt_state),
                                  jax.device_get(js.router_states), tm.cfg)
    la, lb = _state_leaves(ts), _state_leaves(want)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x is None and y is None or torch.equal(x, y), path
    tstep = make_train_step(tm, adamw.from_model_config(tm.cfg),
                            schedules.linear_warmup_cosine(1e-3, 1, 10))
    for bj, bt in zip(batches[1:], list(make_batches(tm.cfg, 4, 32, 3))[1:]):
        js, mj = jstep(js, bj)
        ts, mt = tstep(ts, bt)
        qj = np.stack([s["q"].numpy() for s in
                       router_states_from_numpy(jax.device_get(js.router_states), tm.cfg)])
        qt = np.stack([s["q"].numpy() for s in ts.router_states])
        if strategy == "bip":
            np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
            np.testing.assert_allclose(qt, qj, atol=0.01)
        else:
            np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-3)
            np.testing.assert_allclose(qt, qj, atol=1e-7)
    assert ts.opt_state["step"] == 3


def test_port_checkpoint_passes_reference_verify(tmp_path):
    """A TrainState saved by the port (bf16 first moments, so the uint16
    view is exercised) passes the reference's load_pytree(verify=True) and
    its CheckpointManager; every leaf is bit-equal to the port's state in
    the reference layout, and the port restores it bit-equal."""
    _, tcfg = _cfgs("lossfree", adam_mu_dtype="bf16")
    tm = Model(tcfg, device="cpu")
    opt = adamw.from_model_config(tcfg)
    ts = init_train_state(tm, 0, opt)
    ts, _ = make_train_step(tm, opt, schedules.constant(1e-3))(ts, next(iter(make_batches(tcfg, 4, 32, 1))))
    d = str(tmp_path / "ck")
    path = CheckpointManager(d).save_train_state(ts, tcfg, data_state={"x": 1})
    assert os.path.basename(path) == "step_1.npz"
    tree = jax_store.load_pytree(path, verify=True)
    assert jax_store.verify_checkpoint(path, deep=True)
    assert tree["opt_state"]["step"].dtype == np.int32 and tree["opt_state"]["step"].shape == ()
    assert tree["opt_state"]["mu"]["embed"]["tok"].dtype.name == "bfloat16"
    _assert_trees_bit_equal(tree, train_state_to_tree(ts, tcfg))
    step, jstate = jax_store.CheckpointManager(d).restore_train_state()
    assert step == 1 and int(jstate.opt_state["step"]) == 1
    jcfg, _ = _cfgs("lossfree", adam_mu_dtype="bf16")
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jax_loop.init_train_state(
        jm, jax.random.PRNGKey(0), jax_adamw.from_model_config(jcfg)))
    assert jax.tree.structure(shapes) == jax.tree.structure(jstate)
    with np.load(path) as z:  # each leaf's crc32 is the reference's: crc32 of its bytes
        meta = __import__("json").loads(bytes(z["__meta__"]).decode())
        for name, info in meta.items():
            if info["dtype"] != "NoneType":
                assert info["crc32"] == zlib.crc32(np.ascontiguousarray(z[name]).tobytes())
    _, back = CheckpointManager(d).restore_train_state(tcfg)
    for (p, x), (_, y) in zip(_state_leaves(back), _state_leaves(ts)):
        assert x is None and y is None or torch.equal(x, y.detach()), p
    assert back.opt_state["step"] == 1


def test_async_save_equals_blocking_and_survives_the_next_step(tmp_path):
    """An async save returns after its snapshot: the in-place step that
    follows must not reach the file, which equals a blocking save taken
    before that step."""
    _, tcfg = _cfgs("lossfree")
    tm = Model(tcfg, device="cpu")
    opt = adamw.from_model_config(tcfg)
    step_fn = make_train_step(tm, opt, schedules.constant(1e-3))
    batches = list(make_batches(tcfg, 4, 32, 2))
    ts, _ = step_fn(init_train_state(tm, 0, opt), batches[0])
    blocking = CheckpointManager(str(tmp_path / "b")).save_train_state(ts, tcfg)
    mgr = CheckpointManager(str(tmp_path / "a"))
    path = mgr.save_train_state(ts, tcfg, block=False)
    ts, _ = step_fn(ts, batches[1])  # overwrites params and moments in place
    mgr.wait()
    rec = mgr.saves[-1]
    assert rec["step"] == 1 and rec["bytes"] == os.path.getsize(path) and rec["writer_s"] > 0
    _assert_trees_bit_equal(load_pytree(path, verify=True), load_pytree(blocking, verify=True))


def test_corrupt_newest_checkpoint_resume_falls_back_and_replays(tmp_path):
    """ckpt_corrupt bit-flips the third save (step 6): resume warns, falls
    back to step 4, replays 4..7, and the replayed losses equal those of an
    uninterrupted run."""
    _, tcfg = _cfgs("lossfree")
    tm = Model(tcfg, device="cpu")
    d = str(tmp_path / "cc")
    _, log0 = train_loop(tm, SyntheticBatchStream(tcfg, 4, 32, 8), lr=1e-3, total_steps=8)
    train_loop(tm, SyntheticBatchStream(tcfg, 4, 32, 6), lr=1e-3, total_steps=8,
               ckpt_dir=d, ckpt_every=2, async_ckpt=False,
               faults=FaultPlan.from_specs(["ckpt_corrupt@step=2,mode=bitflip"]))
    assert checkpoint_steps(d) == [2, 4, 6]
    with pytest.warns(UserWarning, match="falling back"):
        _, log = train_loop(tm, SyntheticBatchStream(tcfg, 4, 32, 8), lr=1e-3,
                            total_steps=8, ckpt_dir=d, ckpt_every=100, resume=True)
    assert log.losses == log0.losses[4:]
