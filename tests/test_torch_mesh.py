"""The port's mesh layer against the reference's: sharding rules, the
sharded dispatch plan, the collectives, the three expert-parallel MoE paths,
K3's collective form and the sync='global' duals.

The specs and the dispatch plan are compared in this process. Everything
else runs once per module: eight gloo ranks of the port on the CPU (the
2x4 and the 4x2 mesh over them; tests/_torch_mesh_ranks.mesh_checks) beside
one subprocess of the reference on its forced 8-device mesh, both on the
numpy-seeded inputs this module writes; the tests then compare the two
with the port's single-device functions run here. Tolerances are the
reference anchors' (tests/test_distributed.py, tests/test_moe_dispatch.py,
tests/test_train_sharded.py): EP forward and gradients 2e-4 (fp32, topk,
capacity factor 4), load histograms bit-equal, the collective K3
bit-equal to its single-device plain version and within 2/512 + 5e-3 of
the reference's bisection dual.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _forced_devices import PRELUDE  # noqa: E402
from _torch_mesh_ranks import (  # noqa: E402
    EXPERT_SPECS,
    K3_SHAPES,
    MOE_FNS,
    ROUTER_CASES,
    mesh_checks,
    moe_cfg,
)
from _torch_mesh_util import alongside, run_ranks  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.core import router as jax_router  # noqa: E402
from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import RouterConfig, init_router_state, make_dispatch_plan, ref_bip, route  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import bip_admm  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models.model import _OnMeta, abstract_params  # noqa: E402
from repro_torch.optim.adamw import tree_paths  # noqa: E402
from repro_torch.training import TrainState  # noqa: E402

MESHES = {  # the reference anchors' host meshes and the production pod meshes
    "4x2": {"data": 4, "model": 2},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
K3_BOUND = 2.0 / 512 + 5e-3


def _mesh(shape):
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


# ------------------------------------------------- check 1: sharding rules


def _ref_flat(tree):
    """{path: spec} of a reference spec tree, paths in the port's spelling."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        keys = [p.key if hasattr(p, "key") else p.idx for p in path]
        out[tuple(keys)] = tuple(spec)
    return out


def _ref_in_port_layout(flat, cfg):
    """The reference's per-position group stacks -> one entry per port layer
    (the stack axis dropped); other leaves as they are."""
    period = cfg.scan_period()
    out = {}
    for keys, spec in flat.items():
        if keys[:2] == ("stack", "blocks"):
            j, rest = keys[2], keys[3:]
            for i in range(j, cfg.n_layers, period):
                out[("stack", "layers", i) + rest] = spec[1:]
        elif keys[:2] == ("encoder", "layers"):
            for i in range(cfg.n_enc_layers):
                out[("encoder", "layers", i) + keys[2:]] = spec[1:]
        else:
            out[keys] = spec
    return out


def _port_flat(tree, specs, keys=()):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _port_flat(tree[k], specs[k], keys + (k,)).items()}
    if isinstance(tree, list):
        return {k2: v for i, (t, s) in enumerate(zip(tree, specs))
                for k2, v in _port_flat(t, s, keys + (i,)).items()}
    return {} if tree is None else {keys: tuple(specs)}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_reference(arch):
    """param_specs, train_state_specs, batch_specs and cache_specs give the
    reference's spec for every leaf of every config at the four meshes
    (full sizes: the params are meta tensors / eval_shape structs)."""
    jcfg, cfg = jax_configs.get(arch), configs.get(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    params = abstract_params(cfg)
    state = TrainState(params=params, opt_state={"step": 0, "mu": params, "nu": params},
                       router_states=Model(cfg, device="cpu").init_router_states())
    caches = []  # (batch rows, reference cache, port cache); encdec refuses the slot cache
    for b in ((4, 1) if not cfg.n_enc_layers else ()):
        with _OnMeta():
            tcache = Model(cfg, device="cpu").init_slot_cache(params, b, 64)
        caches.append((b, jax.eval_shape(lambda p, b=b: jmodel.init_slot_cache(p, b, 64), jparams), tcache))
    for label, shape in MESHES.items():
        mesh = _mesh(shape)
        want = _ref_in_port_layout(_ref_flat(jax_sharding.param_specs(jparams, jcfg, mesh)), cfg)
        got_specs = sharding.param_specs(params, cfg, mesh)
        assert _port_flat(params, got_specs) == want, label
        st = sharding.train_state_specs(state, cfg, mesh)
        assert st.params is not None and st.opt_state["step"] == ()
        for tree in (st.params, st.opt_state["mu"], st.opt_state["nu"]):
            assert _port_flat(params, tree) == want, label
        assert all(s == () for s in _port_flat(state.router_states, st.router_states).values())
        for b in (8, 1, 2):
            assert sharding.batch_specs(cfg, mesh, b) == {
                k: tuple(v) for k, v in jax_sharding.batch_specs(jcfg, mesh, b).items()}, (label, b)
        for b, jc, tc in caches:
            want_c = _cache_layout(_ref_flat(jax_sharding.cache_specs(jc, jcfg, mesh, b)), cfg)
            assert _port_flat(tc, sharding.cache_specs(tc, cfg, mesh, b)) == want_c, (label, b)


def _cache_layout(flat, cfg):
    """The reference's cache {'blocks': [per-position stacks]} -> the
    port's {'layers': [per layer]} (the stack axis dropped)."""
    period = cfg.scan_period()
    out = {}
    for keys, spec in flat.items():  # ('blocks', j, leaf) -> ('layers', i, leaf)
        for i in range(keys[1], cfg.n_layers, period):
            out[("layers", i) + keys[2:]] = spec[1:]
    return out


def test_mesh_ctx_and_state_specs():
    """make_mesh_ctx, MeshCtx.use_ep / batch_spec, and moe._state_specs as
    the reference's."""
    ctx = sharding.make_mesh_ctx(_mesh(MESHES["2x16x16"]))
    assert ctx.data_axes == ("pod", "data") and ctx.model_axis == "model" and ctx.use_ep
    assert ctx.batch_spec == ("pod", "data")
    assert sharding.make_mesh_ctx(_mesh(MESHES["4x2"])).batch_spec == "data"
    assert not sharding.make_mesh_ctx(None).use_ep
    state = init_router_state(RouterConfig(n_experts=8, top_k=2, strategy="lpr"))
    assert moe._state_specs(state) == {k: (None,) for k in state}


def test_names_carried_over_from_the_reference():
    """The names kept as the reference has them: EP2D_TOKEN_THRESHOLD's
    value, default_controls' values (and a guarded step under them is the
    unguarded step, bit for bit), MeshCtx.constrain handing its tensor
    back (every tensor is already the rank's block)."""
    from repro.models import moe as jax_moe
    from repro.training.loop import default_controls as jax_default_controls
    from repro_torch.data import make_batches
    from repro_torch.optim import constant, from_model_config
    from repro_torch.training import default_controls, init_train_state, make_train_step

    assert moe.EP2D_TOKEN_THRESHOLD == jax_moe.EP2D_TOKEN_THRESHOLD
    np.testing.assert_array_equal(default_controls(), np.asarray(jax_default_controls()))
    x = torch.ones(3)
    assert sharding.make_mesh_ctx(_mesh(MESHES["4x2"])).constrain(x, "data", None) is x
    cfg = configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256)
    model, opt = Model(cfg, device="cpu"), from_model_config(cfg)
    batch = next(iter(make_batches(cfg, 2, 16, 1, seed=0)))
    plain, m_plain = make_train_step(model, opt, constant(1e-3))(init_train_state(model, 0, opt), batch)
    guarded, m_guarded = make_train_step(model, opt, constant(1e-3), guarded=True)(
        init_train_state(model, 0, opt), batch, default_controls())
    assert bool(m_guarded["step_ok"]) and float(m_plain["loss"]) == float(m_guarded["loss"])
    for (path, a), (_, b) in zip(tree_paths(plain.params), tree_paths(guarded.params)):
        assert torch.equal(a, b), path


# ------------------------------------------------- check 2: dispatch plan


@pytest.mark.parametrize("n,m,k,cap", [(80, 8, 2, 11), (64, 16, 4, 5), (33, 4, 1, 40)])
def test_plan_sharded_pack_matches_reference(n, m, k, cap):
    """pack/combine with expert_offset and n_local equal the reference's,
    and the per-shard packs tile the whole one (test_moe_dispatch.py:131)."""
    rng = np.random.default_rng(n + m)
    idx = np.stack([rng.permutation(m)[:k] for _ in range(n)]).astype(np.int32)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    w = rng.random((n, k)).astype(np.float32)
    jplan = jax_router.make_dispatch_plan(jnp.asarray(idx), m, cap)
    plan = make_dispatch_plan(torch.from_numpy(idx), m, cap)
    whole = plan.pack(torch.from_numpy(x))
    for m_loc in sorted({1, 2, m // 2}):
        shards = []
        for off in range(0, m, m_loc):
            got = plan.pack(torch.from_numpy(x), expert_offset=off, n_local=m_loc)
            ref = jplan.pack(jnp.asarray(x), expert_offset=off, n_local=m_loc)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            shards.append(got)
            yc = plan.combine(whole[off:off + m_loc], torch.from_numpy(w), expert_offset=off)
            ref_c = jplan.combine(jnp.asarray(whole[off:off + m_loc].numpy()), jnp.asarray(w),
                                  expert_offset=off)
            np.testing.assert_allclose(yc.numpy(), np.asarray(ref_c), atol=1e-6)
        np.testing.assert_array_equal(torch.cat(shards).numpy(), whole.numpy())


# ------------------------------------------- checks 3-5: ranks + reference


REF = r"""
import pickle
from repro.configs.base import ModelConfig, RoutingSpec
from repro.core import RouterConfig, init_router_state, ref_bip, route
from repro.models import moe
from repro.models.moe import _shard_map
from jax import lax

inp = dict(np.load(WD + "/inputs.npz"))
out = {}
mesh24 = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
mesh42 = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))

cfg = ModelConfig(n_layers=2, d_model=64, d_ff=128, compute_dtype=jnp.float32,
                  routing=RoutingSpec(n_experts=8, top_k=2, strategy="topk", capacity_factor=4.0),
                  moe_d_ff=96)
params = {k: jnp.asarray(inp["moe_" + k]) for k in ("w_router", "w_gate", "w_up", "w_down")}
xs = jax.device_put(jnp.asarray(inp["moe_x"]), NamedSharding(mesh24, P("data", None)))
ms = jax.device_put(jnp.asarray(inp["moe_mask"]), NamedSharding(mesh24, P("data")))
state = init_router_state(moe.router_config(cfg))
for name in MOE_FNS:
    for masked in (False, True):
        def loss(p, fn=getattr(moe, name), masked=masked):
            y, _, _, mets = fn(p, xs, state, cfg, mesh24, data_axes=("data",), model_axis="model",
                               token_mask=ms if masked else None)
            return jnp.sum(y ** 2), (y, mets["load"])
        with mesh24:
            (_, (y, load)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        key = f"{name}_{int(masked)}"
        out[key + "_y"] = np.asarray(jax.device_get(y))
        out[key + "_load"] = np.asarray(jax.device_get(load))
        for k, v in g.items():
            out[key + "_g_" + k] = np.asarray(jax.device_get(v))

def on42(f, *specs):
    return jax.jit(_shard_map(f, mesh=mesh42, in_specs=specs, out_specs=P(None)))

ax = ("data",)
with mesh42:
    for n, m, k, t in K3_SHAPES:
        f = on42(lambda s, q, k=k, t=t: ref_bip.bip_dual_update_global(
            s, q, top_k=k, n_iters=t, axis_names=ax)[0], P("data", None), P(None))
        out[f"k3_{n}_{m}"] = np.asarray(f(inp[f"k3_s_{n}_{m}"], inp[f"k3_q0_{n}_{m}"]))
    s, q0 = inp["gd_s"], inp["gd_q0"]
    out["gd_a"] = np.asarray(on42(lambda s, q: ref_bip.bip_dual_update_global(
        s, q, top_k=4, n_iters=4, axis_names=ax)[0], P("data", None), P(None))(s, q0))
    out["gd_b"] = np.asarray(on42(lambda s, q, mk: ref_bip.bip_dual_update_global(
        s, q, top_k=4, n_iters=4, token_mask=mk, axis_names=ax, fanout=32,
        score_bounds=(0.0, 1.0))[0], P("data", None), P(None), P("data"))(s, q0, inp["gd_mask"]))
    def win(s, q, lo, hi):
        q, _, t = ref_bip.bip_dual_update_global(
            s, q, top_k=4, n_iters=4, axis_names=ax, fanout=32, score_bounds=(0.0, 1.0),
            window=(lo, hi), with_stats=True)
        return jnp.stack([q, t])
    qt = np.asarray(on42(win, P("data", None), P(None), P(None), P(None))(
        s, q0, inp["gd_wlo"], inp["gd_whi"]))
    out["gd_c"], out["gd_c_t"] = qt[0], qt[1]

for m, k, iters, forecast in ROUTER_CASES:
    rcfg = RouterConfig(n_experts=m, top_k=k, strategy="bip", bip_iters=iters, sync="global",
                        data_axes=("data",), forecast=forecast)
    st = init_router_state(rcfg)
    specs = jax.tree.map(lambda _: P(None), st)
    def block(lg, st):
        o = route(lg, st, rcfg)
        return o.state, lax.psum(o.metrics["load"], "data")
    step = jax.jit(_shard_map(block, mesh=mesh42, in_specs=(P("data", None), specs),
                              out_specs=(specs, P(None))))
    tag = f"rt_{m}_{int(forecast)}"
    for i, logits in enumerate(inp[tag]):
        with mesh42:
            st, load = step(logits, st)
        st = jax.device_get(st)
        out[f"{tag}_{i}_load"] = np.asarray(jax.device_get(load))
        for key, v in st.items():
            out[f"{tag}_{i}_{key}"] = np.asarray(v)

with open(WD + "/ref.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    d, m, f, n = 64, 8, 96, 256
    inp = {
        "moe_w_router": rng.standard_normal((d, m)) / 8,
        "moe_w_gate": rng.standard_normal((m, d, f)) / 8,
        "moe_w_up": rng.standard_normal((m, d, f)) / 8,
        "moe_w_down": rng.standard_normal((m, f, d)) / 10,
        "moe_x": rng.standard_normal((n, d)),
        "moe_mask": rng.random(n) < 0.7,
    }

    def scores(n, m, skew):
        logits = rng.standard_normal((n, m)) + skew * np.linspace(2, -2, m)[None, :]
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    for n, m, k, t in K3_SHAPES:
        inp[f"k3_s_{n}_{m}"] = scores(n, m, 1.0)
        inp[f"k3_q0_{n}_{m}"] = rng.random(m) * 0.05
    inp["gd_s"] = scores(512, 16, 1.0)
    inp["gd_q0"] = rng.random(16) * 0.05
    inp["gd_mask"] = rng.random(512) < 0.8
    centre = rng.random(16) * 0.3
    inp["gd_wlo"], inp["gd_whi"] = centre - 0.05, centre + 0.05
    for m, k, iters, forecast in ROUTER_CASES:
        inp[f"rt_{m}_{int(forecast)}"] = np.stack([
            rng.standard_normal((512, m)) + (1.0 + 0.2 * t) * np.linspace(2, -2, m)[None, :]
            for t in range(4)])
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in inp.items()}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    np.savez(wd / "inputs.npz", **inp)
    code = (PRELUDE + f"WD = {str(wd)!r}\nMOE_FNS = {MOE_FNS!r}\nK3_SHAPES = {K3_SHAPES!r}\n"
            f"ROUTER_CASES = {ROUTER_CASES!r}\n" + REF)
    ranks = alongside(code, lambda: run_ranks(mesh_checks, 8, wd))
    import pickle

    with open(wd / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return inp, ranks, ref


def test_collectives_rank_order_and_transposes(mesh_run):
    """Every group orders its ranks by mesh coordinate, and every
    differentiable collective has shard_map's transpose."""
    _, ranks, _ = mesh_run
    for out in ranks:
        p = out["probe"]
        np.testing.assert_array_equal(p["data_order"], np.arange(4.0))
        np.testing.assert_array_equal(p["model_order"], np.arange(2.0))
        np.testing.assert_array_equal(p["flat_order"], np.arange(8.0))
        assert p["pmin_pmax"] == (0.0, 3.0)
        assert max(p["grad_errs"].values()) == 0.0, p["grad_errs"]


def test_mesh_ctx_coords_on_the_ranks(mesh_run):
    """MeshCtx.coords: rank r sits at (r // model, r % model) on both host
    meshes, the row-major layout of the reference's device array."""
    _, ranks, _ = mesh_run
    for out in ranks:
        r = out["rank"]
        assert out["coords"] == {"2x4": {"data": r // 4, "model": r % 4},
                                 "4x2": {"data": r // 2, "model": r % 2}}, out["coords"]


def _local_moe(inp, masked):
    cfg = moe_cfg()
    params = {k: torch.from_numpy(inp["moe_" + k]).requires_grad_(True) for k in EXPERT_SPECS}
    y, _, _, mets = moe.moe_ffn_local(params, torch.from_numpy(inp["moe_x"]),
                                      init_router_state(moe.router_config(cfg)), cfg,
                                      token_mask=torch.from_numpy(inp["moe_mask"]) if masked else None)
    (y ** 2).sum().backward()
    return y.detach().numpy(), mets["load"].numpy(), {k: v.grad.numpy() for k, v in params.items()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", MOE_FNS)
def test_ep_paths_match_local_and_reference(mesh_run, name, masked):
    """moe_ffn_ep / ep2d / ep2ds on the 2x4 mesh: forward, load histogram
    and the gradients of all four weights equal moe_ffn_local's and the
    reference's same-named function's (test_moe_dispatch.py:204,
    test_distributed.py:98), with and without a token mask."""
    inp, ranks, ref = mesh_run
    y0, load0, g0 = _local_moe(inp, masked)
    key = f"{name}_{int(masked)}"
    got = ranks[0]
    for other in (y0, ref[key + "_y"]):
        np.testing.assert_allclose(got[key + "_y"], other, atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(got[key + "_load"], load0)
    np.testing.assert_array_equal(got[key + "_load"], ref[key + "_load"])
    for k in EXPERT_SPECS:
        for other in (g0[k], ref[key + "_g_" + k]):
            np.testing.assert_allclose(got[key + "_g_" + k], other, atol=2e-4, rtol=2e-4, err_msg=k)
    for out in ranks[1:]:  # every rank returns the same whole tensors
        np.testing.assert_array_equal(out[key + "_y"], got[key + "_y"])


@pytest.mark.parametrize("n,m,k,n_iters", K3_SHAPES)
def test_k3_collective_form(mesh_run, n, m, k, n_iters):
    """K3's collective form over 4 data shards: q bit-equal on every rank to
    the single-device plain K3 on the whole scores, and within 2/512 + 5e-3
    of the reference's bip_dual_update_global on the forced mesh."""
    inp, ranks, ref = mesh_run
    s, q0 = torch.from_numpy(inp[f"k3_s_{n}_{m}"]), torch.from_numpy(inp[f"k3_q0_{n}_{m}"])
    want = bip_admm.bip_dual_update_plain(s, q0, top_k=k, n_iters=n_iters).numpy()
    for out in ranks:
        np.testing.assert_array_equal(out[f"k3_{n}_{m}"], want)
    assert np.abs(want - ref[f"k3_{n}_{m}"]).max() <= K3_BOUND


def test_global_dual_update_on_mesh(mesh_run):
    """bip_dual_update_global with axis_names: unmasked with pmin/pmax
    bounds, masked with static bounds and fanout 32, and with the
    forecaster's window: bit-equal to the single-device call on the whole
    batch and to the reference's on its mesh."""
    inp, ranks, ref = mesh_run
    s, q0 = torch.from_numpy(inp["gd_s"]), torch.from_numpy(inp["gd_q0"])
    single = {
        "gd_a": ref_bip.bip_dual_update_global(s, q0, top_k=4, n_iters=4)[0],
        "gd_b": ref_bip.bip_dual_update_global(s, q0, top_k=4, n_iters=4,
                                               token_mask=torch.from_numpy(inp["gd_mask"]),
                                               fanout=32, score_bounds=(0.0, 1.0))[0],
    }
    q, _, t = ref_bip.bip_dual_update_global(
        s, q0, top_k=4, n_iters=4, fanout=32, score_bounds=(0.0, 1.0),
        window=(torch.from_numpy(inp["gd_wlo"]), torch.from_numpy(inp["gd_whi"])), with_stats=True)
    single.update(gd_c=q, gd_c_t=t)
    for key, want in single.items():
        for out in ranks:
            np.testing.assert_array_equal(out[key], want.numpy(), err_msg=key)
        np.testing.assert_array_equal(ref[key], want.numpy(), err_msg=key)


@pytest.mark.parametrize("case", ROUTER_CASES, ids=lambda c: f"{c[0]}e_forecast{int(c[3])}")
def test_global_sync_route_trajectory(mesh_run, case):
    """sync='global' route() on the 4x2 mesh's token shards for four steps
    of drifting skew: q (and the forecaster's EMAs) and the psum'd load
    histogram bit-equal to the single-device route on the whole batch at
    every step. Against the reference's sharded route
    (test_train_sharded.py:261, 408) the scores are each library's softmax
    of the same logits, which differ by ulps, so BIP's LP-degenerate
    capacity boundary may move a marginal token: held within ROADMAP
    queue 3, item 2 (q within 1e-4, MaxVio within one token)."""
    inp, ranks, ref = mesh_run
    m, k, iters, forecast = case
    cfg = RouterConfig(n_experts=m, top_k=k, strategy="bip", bip_iters=iters, sync="global",
                       forecast=forecast)
    state = init_router_state(cfg)
    tag = f"rt_{m}_{int(forecast)}"
    token = 1.0 / (512 * k / m)  # one token of MaxVio: 1 / mean load
    for i, logits in enumerate(inp[tag]):
        o = route(torch.from_numpy(logits), state, cfg)
        state = o.state
        want = {"load": o.metrics["load"].numpy(), **{key: v.numpy() for key, v in state.items()}}
        for key, v in want.items():
            for out in ranks:
                np.testing.assert_array_equal(out[f"{tag}_{i}_{key}"], v, err_msg=f"step {i} {key}")
            if key != "load":
                np.testing.assert_allclose(ref[f"{tag}_{i}_{key}"], v, atol=1e-4, err_msg=f"step {i} {key}")
        vio = lambda load: load.max() / (512 * k / m) - 1.0  # noqa: E731
        assert abs(vio(ref[f"{tag}_{i}_load"]) - vio(want["load"])) <= token + 1e-9, i
