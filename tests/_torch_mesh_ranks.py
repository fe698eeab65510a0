"""Rank bodies of the port's mesh tests: what every gloo rank runs (see
tests/_torch_mesh_util.run_ranks). torch and numpy only: a rank imports
nothing of jax or of the reference package. Inputs come from the
numpy-seeded `inputs.npz` the test wrote into the working directory; each
rank returns its results to the test process, which compares them. Not
collected by pytest (no test_ prefix)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MOE_FNS = ("moe_ffn_ep", "moe_ffn_ep2d", "moe_ffn_ep2ds")
K3_SHAPES = ((512, 16, 4, 4), (1024, 64, 8, 2))
ROUTER_CASES = ((16, 4, 4, False), (16, 4, 4, True), (64, 8, 14, False))
EXPERT_SPECS = {"w_router": (None, None), "w_gate": ("model", None, "data"),
                "w_up": ("model", None, "data"), "w_down": ("model", "data", None)}


def moe_cfg():
    """The reference anchors' MoE layer: 8 experts top-2, topk routing,
    capacity factor 4 (no drops at either granularity), fp32 compute."""
    from repro_torch.configs.base import ModelConfig, RoutingSpec

    return ModelConfig(n_layers=2, d_model=64, d_ff=128, compute_dtype=torch.float32,
                       routing=RoutingSpec(n_experts=8, top_k=2, strategy="topk", capacity_factor=4.0),
                       moe_d_ff=96)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def collectives_probe(mesh):
    """Rank order of the groups and the backward of every differentiable
    collective, against what this rank can work out alone."""
    from repro_torch.distributed import collectives as C

    out = {}
    with C.axis_env(mesh):
        d, r = C.axis_index("data"), C.axis_index("model")
        n_d = C.axis_size("data")
        out["data_order"] = _np(C.all_gather(torch.tensor([float(d)]), "data"))
        out["model_order"] = _np(C.all_gather(torch.tensor([float(r)]), "model"))
        out["flat_order"] = _np(C.all_gather(torch.tensor([float(C.axis_index(("data", "model")))]),
                                             ("data", "model")))
        z = [torch.arange(8.0) * (j + 1) for j in range(n_d)]  # rank j of data holds z[j]
        errs = {}
        x = torch.arange(2.0, requires_grad=True)
        C.psum(x * (d + 1), "data").mul(torch.tensor([3.0, 5.0])).sum().backward()
        errs["psum"] = float((x.grad - torch.tensor([3.0, 5.0]) * (d + 1)).abs().max())
        w = torch.ones(8, requires_grad=True)
        (C.pvary(w, "data") * z[d]).sum().backward()
        errs["pvary"] = float((w.grad - sum(z)).abs().max())
        x = torch.ones(2, requires_grad=True)
        (C.all_gather(x, "data") * z[d]).sum().backward()
        errs["all_gather"] = float((x.grad - sum(zj[2 * d:2 * d + 2] for zj in z)).abs().max())
        x = torch.ones(2, requires_grad=True)
        (C.all_gather(x, "data", invariant=True) * z[0]).sum().backward()
        errs["all_gather_invariant"] = float((x.grad - z[0][2 * d:2 * d + 2]).abs().max())
        x = torch.ones(8, requires_grad=True)
        (C.psum_scatter(x, "data") * z[d][:2]).sum().backward()
        errs["psum_scatter"] = float((x.grad - torch.cat([zj[:2] for zj in z])).abs().max())
        x = torch.ones(8, requires_grad=True)
        (C.shard_rows(x, "data") * z[0][2 * d:2 * d + 2]).sum().backward()
        errs["shard_rows"] = float((x.grad - z[0]).abs().max())
        out["pmin_pmax"] = (float(C.pmin(torch.tensor(float(d)), "data")),
                            float(C.pmax(torch.tensor(float(d)), "data")))
        out["grad_errs"] = errs
    return out


def moe_paths(mesh, inp):
    """Check 3: each EP path's output, loads and gradients (loss sum(y^2))
    on this mesh, gathered whole."""
    from repro_torch.core.types import init_router_state
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import shard_tree, unshard_tree
    from repro_torch.models import moe

    cfg = moe_cfg()
    params = {k: _t(inp["moe_" + k]) for k in EXPERT_SPECS}
    x, mask = _t(inp["moe_x"]), _t(inp["moe_mask"])
    out = {}
    for name in MOE_FNS:
        for masked in (False, True):
            blocks = shard_tree(params, EXPERT_SPECS, mesh)
            for v in blocks.values():
                v.requires_grad_(True)
            with C.axis_env(mesh):  # the model gathers w_router so: summed over data
                w_router = C.pvary(blocks["w_router"], "data")
            y, _, _, mets = getattr(moe, name)(
                dict(blocks, w_router=w_router), shard_tree(x, ("data", None), mesh),
                init_router_state(moe.router_config(cfg)), cfg, mesh, data_axes=("data",),
                model_axis="model", token_mask=shard_tree(mask, ("data",), mesh) if masked else None)
            (y ** 2).sum().backward()
            grads = unshard_tree({k: v.grad for k, v in blocks.items()}, EXPERT_SPECS, mesh)
            key = f"{name}_{int(masked)}"
            out[key + "_y"] = _np(unshard_tree(y.detach(), ("data", None), mesh))
            out[key + "_load"] = _np(mets["load"])
            for k, g in grads.items():
                out[key + "_g_" + k] = _np(g)
    return out


def k3_collective(mesh, inp):
    """Check 4: K3's collective form over the data ranks (plain single pass
    on the CPU, counts psum'd)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import shard_tree
    from repro_torch.kernels import bip_admm

    out = {}
    with C.axis_env(mesh):
        for n, m, k, n_iters in K3_SHAPES:
            s = shard_tree(_t(inp[f"k3_s_{n}_{m}"]), ("data", None), mesh)
            q = bip_admm.bip_dual_update(s, _t(inp[f"k3_q0_{n}_{m}"]), top_k=k, n_iters=n_iters,
                                         axis_names=("data",))
            out[f"k3_{n}_{m}"] = _np(q)
    return out


def global_duals(mesh, inp):
    """Check 5: bip_dual_update_global with axis_names (three variants) and
    a few steps of sync='global' route() on the rank's token shard."""
    from repro_torch.core import RouterConfig, init_router_state, ref_bip, route
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import shard_tree

    out = {}
    rows = lambda a: shard_tree(_t(a), ("data",) + (None,) * (a.ndim - 1), mesh)  # noqa: E731
    s, q0 = rows(inp["gd_s"]), _t(inp["gd_q0"])
    with C.axis_env(mesh):
        ax = ("data",)
        out["gd_a"] = _np(ref_bip.bip_dual_update_global(s, q0, top_k=4, n_iters=4, axis_names=ax)[0])
        out["gd_b"] = _np(ref_bip.bip_dual_update_global(
            s, q0, top_k=4, n_iters=4, token_mask=rows(inp["gd_mask"]), axis_names=ax, fanout=32,
            score_bounds=(0.0, 1.0))[0])
        q, _, t = ref_bip.bip_dual_update_global(
            s, q0, top_k=4, n_iters=4, axis_names=ax, fanout=32, score_bounds=(0.0, 1.0),
            window=(_t(inp["gd_wlo"]), _t(inp["gd_whi"])), with_stats=True)
        out["gd_c"], out["gd_c_t"] = _np(q), _np(t)
        for m, k, iters, forecast in ROUTER_CASES:
            cfg = RouterConfig(n_experts=m, top_k=k, strategy="bip", bip_iters=iters, sync="global",
                               data_axes=ax, forecast=forecast)
            state = init_router_state(cfg)
            tag = f"rt_{m}_{int(forecast)}"
            for step, logits in enumerate(inp[tag]):
                o = route(rows(logits), state, cfg)
                state = o.state
                out[f"{tag}_{step}_load"] = _np(C.psum(o.metrics["load"], ax))
                for key, v in state.items():
                    out[f"{tag}_{step}_{key}"] = _np(v)
    return out


def mesh_checks(rank, world, workdir):
    """Everything test_torch_mesh.py asks of a rank (8 ranks: the 2x4 and
    the 4x2 mesh over them)."""
    from repro_torch.distributed import make_mesh_ctx
    from repro_torch.launch.mesh import make_host_mesh

    inp = dict(np.load(workdir / "inputs.npz"))
    mesh24, mesh42 = make_host_mesh(2, 4), make_host_mesh(4, 2)
    out = {"probe": collectives_probe(mesh42), "rank": rank,
           "coords": {"2x4": make_mesh_ctx(mesh24).coords, "4x2": make_mesh_ctx(mesh42).coords}}
    out.update(moe_paths(mesh24, inp))
    out.update(k3_collective(mesh42, inp))
    out.update(global_duals(mesh42, inp))
    return out


# ------------------------------------------------------------ training


def train_cfg(configs, impl="auto", sync_global=False):
    """The reference anchors' reduced minimind-16e, vocab 256: its reduced
    routing (4 experts top-2) for the one-step check; for the sync='global'
    loop the full routing table (16 experts top-4) with capacity factor 8,
    so neither granularity drops a token."""
    if sync_global:
        full = configs.get("minimind_moe_16e")
        routing = dataclasses.replace(full.routing, sync="global", capacity_factor=8.0, moe_impl=impl)
        return configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256, routing=routing)
    cfg = configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256)
    return dataclasses.replace(cfg, routing=dataclasses.replace(cfg.routing, moe_impl=impl))


def train_checks(rank, world, workdir, impls, loop_steps):
    """Check 6 on a 4x2 mesh: one sharded step from the reference's state
    (state.pkl, converted) through each EP path, then train_loop(mesh=)
    under sync='global' from loop_state.pkl."""
    from repro_torch import configs
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data import make_batches
    from repro_torch.distributed import make_mesh_ctx, shard_tree, train_state_specs, unshard_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, schedules
    from repro_torch.training import compile_train_step, train_loop

    import pickle

    mesh = make_host_mesh(4, 2)
    with open(workdir / "state.pkl", "rb") as f:
        ref_state = pickle.load(f)
    with open(workdir / "loop_state.pkl", "rb") as f:
        loop_state = pickle.load(f)
    out = {}
    batch = next(iter(make_batches(train_cfg(configs), 8, 64, 1, seed=0)))
    small = next(iter(make_batches(train_cfg(configs), 2, 64, 1, seed=0)))  # 2 rows: replicated over 4 data ranks
    for impl in impls:
        cfg = train_cfg(configs, impl=impl)
        model = build_model(cfg, make_mesh_ctx(mesh), device="cpu")
        state = train_state_from_numpy(*ref_state, cfg, "cpu")
        specs = train_state_specs(state, cfg, mesh)
        local = shard_tree(state, specs, mesh)
        step = compile_train_step(model, adamw.from_model_config(cfg), schedules.constant(1e-3), state,
                                  batch, mesh=mesh, st_specs=specs)
        local, mets = step(local, shard_tree(batch, {k: ("data", None) for k in batch}, mesh))
        out[f"step_{impl}_loss"] = float(mets["loss"])
        out[f"step_{impl}_grad_norm"] = float(mets["grad_norm"])
        out[f"step_{impl}_params"] = {p: _np(v) for p, v in adamw.tree_paths(
            unshard_tree(local.params, specs.params, mesh))}
        # a batch too small to split over the data ranks rides replicated
        local = shard_tree(state, specs, mesh)
        b_specs = {k: (None, None) for k in small}
        step = compile_train_step(model, adamw.from_model_config(cfg), schedules.constant(1e-3), state,
                                  small, mesh=mesh, st_specs=specs, b_specs=b_specs)
        local, mets = step(local, shard_tree(small, b_specs, mesh))
        out[f"small_{impl}_loss"] = float(mets["loss"])
        out[f"small_{impl}_grad_norm"] = float(mets["grad_norm"])
        out[f"small_{impl}_params"] = {p: _np(v) for p, v in adamw.tree_paths(
            unshard_tree(local.params, specs.params, mesh))}
    cfg = train_cfg(configs, sync_global=True)
    model = build_model(cfg, make_mesh_ctx(mesh), device="cpu")
    state = train_state_from_numpy(*loop_state, cfg, "cpu")
    st, log = train_loop(model, make_batches(cfg, 8, 64, loop_steps, seed=0), lr=1e-3, warmup_steps=2,
                         total_steps=loop_steps, state=state, mesh=mesh)
    out["loop_losses"] = list(log.losses)
    out["loop_vio"] = np.stack(log.max_vio_steps)
    out["loop_q"] = np.concatenate([_np(s["q"]) for s in st.router_states if s is not None])
    return out


# ------------------------------------------------------------- serving


SERVE_STRATEGIES = ("topk", "bip")
# a prompt of more than two chunks beside two short ones, 4 slots x chunk 8
# on 4 data ranks: its chunks spread onto rows whose slots other data
# ranks hold
PACKED_PROMPTS = (21, 4, 6)


def serve_cfg(configs, strategy):
    """The reference test's engine config (tests/test_serving_mesh.py:25):
    reduced minimind-16e, vocab 128, sync='global', capacity factor 4."""
    cfg = configs.reduced_for_smoke("minimind_moe_16e", vocab_size=128)
    return dataclasses.replace(cfg, routing=dataclasses.replace(
        cfg.routing, sync="global", strategy=strategy, capacity_factor=4.0))


def serve_prompts(packed=False):
    """The reference test's six seeded prompts, or the packed case's."""
    rng = np.random.default_rng(0)
    if packed:
        return [rng.integers(0, 128, (n,)).tolist() for n in PACKED_PROMPTS]
    return [rng.integers(0, 128, (int(rng.integers(3, 20)),)).tolist() for _ in range(6)]


def record_plans(eng):
    """Wrap the engine's planner: every step's operand arrays (or None)."""
    plans, orig = [], eng._plan_packed

    def wrapped(active):
        out = orig(active)
        plans.append(None if out is None else [np.asarray(a) for a in out[:-1]])
        return out

    eng._plan_packed = wrapped
    return plans


def serve_stream(engine_cls, model, params, prompts, gen, mesh=None, plans=False):
    """The reference test's loop: 4 slots x chunk 8, submit with
    backpressure, step until done. Returns (tokens, expert load, plans)."""
    eng = engine_cls(model, params, n_slots=4, chunk_size=8, max_seq_len=64, mesh=mesh)
    log = record_plans(eng) if plans else None
    reqs = []
    for p in prompts:
        r = eng.submit(p, gen, ignore_eos=True)
        while r is None:
            eng.step()
            r = eng.submit(p, gen, ignore_eos=True)
        reqs.append(r)
    while eng.scheduler.has_work:
        eng.step()
    return [r.output for r in reqs], eng.expert_load.copy(), log


def formerly_refused(configs):
    """The two setups mesh serving used to refuse, each (name, config,
    slots): a mamba stack (SSM/conv state) and 6 slots over 4 data ranks
    (the cache then splits its length)."""
    return (("mamba", configs.reduced_for_smoke("mamba2_130m"), 4), ("slots", serve_cfg(configs, "topk"), 6))


def serve_small(engine_cls, model, params, n_slots, mesh=None):
    """Two seeded prompts, 3 greedy tokens each, chunk 8, max_seq_len 32."""
    eng = engine_cls(model, params, n_slots=n_slots, chunk_size=8, max_seq_len=32, mesh=mesh)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(0, model.cfg.vocab_size, (n,)), 3, ignore_eos=True) for n in (5, 11)]
    while eng.scheduler.has_work:
        eng.step()
    return [list(map(int, r.output)) for r in reqs], eng.expert_load.copy()


def serve_checks(rank, world, workdir):
    """Everything test_torch_serve_mesh.py asks of a rank: the engine on the
    4x2 mesh from the reference's params (serve_params.pkl, converted) for
    each strategy, the packed case with its plans, and the two setups mesh
    serving used to refuse (`formerly_refused`, from Model.init(0))."""
    import pickle

    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatchingEngine

    mesh = make_host_mesh(4, 2)
    with open(workdir / "serve_params.pkl", "rb") as f:
        tree = pickle.load(f)
    out = {}
    for strategy in SERVE_STRATEGIES:
        cfg = serve_cfg(configs, strategy)
        model = Model(cfg, device="cpu")
        params = params_from_numpy(tree, cfg, "cpu")
        out[strategy] = serve_stream(ContinuousBatchingEngine, model, params, serve_prompts(), 5, mesh)[:2]
    cfg = serve_cfg(configs, "topk")
    out["packed"] = serve_stream(ContinuousBatchingEngine, Model(cfg, device="cpu"),
                                 params_from_numpy(tree, cfg, "cpu"), serve_prompts(True), 4, mesh, plans=True)
    out["refusals"] = {}
    for name, c, n_slots in formerly_refused(configs):
        model = Model(c, device="cpu")
        out["refusals"][name] = serve_small(ContinuousBatchingEngine, model, model.init(0), n_slots, mesh)
    return out


# ------------------------------------------------- serving layouts on a mesh


LAYOUT_MESH = (2, 4)
# (name, arch, config overrides, slots, routing strategy or None, the
# slot cache's layout on the 2x4 mesh: {leaf: spec} of the port's per-layer
# leaves (distributed.cache_specs), each leaf name once)
LAYOUT_CASES = (
    ("mamba2_heads", "mamba2_130m", {}, 4, None,
     {"ssm": ("data", "model", None, None), "conv": ("data", None, "model")}),
    ("mamba2_state", "mamba2_130m", {"d_model": 96}, 4, None,  # 6 SSM heads over 4 model ranks: N splits
     {"ssm": ("data", None, "model", None), "conv": ("data", None, "model")}),
    ("zamba2", "zamba2_7b", {}, 4, None,
     {"ssm": ("data", "model", None, None), "conv": ("data", None, "model"),
      "sk": ("data", None, "model", None), "sv": ("data", None, "model", None), "spos": ("data",)}),
    ("stablelm_length", "stablelm_1_6b", {}, 1, None,
     {"k": (None, "data", "model", None), "v": (None, "data", "model", None), "pos": (None,)}),
    ("gemma2_ring", "gemma2_27b", {"window_size": 16}, 1, None,  # 2 KV heads over 4: head_dim splits too
     {"k": (None, "data", None, "model"), "v": (None, "data", None, "model"), "pos": (None,)}),
    ("stablelm_head_dim", "stablelm_1_6b", {"n_heads": 6, "n_kv_heads": 3}, 4, None,
     {"k": ("data", None, None, "model"), "v": ("data", None, None, "model"), "pos": ("data",)}),
    ("stablelm_replicated", "stablelm_1_6b", {"n_heads": 6, "n_kv_heads": 3, "head_dim": 6}, 2, None,
     {"k": ("data", None, None, None), "v": ("data", None, None, None), "pos": ("data",)}),
    ("minimind_topk", "minimind_moe_16e", {}, 1, "topk",
     {"k": (None, "data", "model", None), "v": (None, "data", "model", None), "pos": (None,)}),
    ("minimind_bip", "minimind_moe_16e", {}, 1, "bip",
     {"k": (None, "data", "model", None), "v": (None, "data", "model", None), "pos": (None,)}),
)
LAYOUT_GEN, LAYOUT_CHUNK, LAYOUT_MAX_SEQ = 5, 8, 64


def layout_cfg(configs, case):
    """A case's reduced config (vocab 128; MoE: sync='global', capacity
    factor 4, its strategy) in either package's configs."""
    _, arch, overrides, _, strategy, _ = case
    cfg = configs.reduced_for_smoke(arch, vocab_size=128, **overrides)
    if strategy is None:
        return cfg
    return dataclasses.replace(cfg, routing=dataclasses.replace(
        cfg.routing, sync="global", strategy=strategy, capacity_factor=4.0))


def layout_prompts():
    """Three seeded prompts of 3-19 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, (int(rng.integers(3, 20)),)).tolist() for _ in range(3)]


def layout_specs(specs):
    """{leaf name: spec} of the port's cache spec tree, each name once."""
    out = {}
    for layer in specs["layers"]:
        for name, spec in layer.items():
            out.setdefault(name, tuple(spec))
    return out


def layout_params(workdir, name, timeout=600.0):
    """A case's reference params tree (numpy), once the test process has
    written `layout_params_<name>.pkl` into `workdir` (it writes them one
    by one while the ranks and the reference's subprocess serve the cases
    before); a `.error` file in its place raises."""
    import pickle
    import time
    from pathlib import Path

    path = Path(workdir) / f"layout_params_{name}.pkl"
    t0 = time.monotonic()
    while not path.exists():
        err = path.with_suffix(".error")
        if err.exists():
            raise RuntimeError(f"the params of {name} were not made:\n{err.read_text()}")
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def layout_stream(engine_cls, model, params, n_slots, mesh=None, logits=False):
    """The case's loop (chunk 8, max_seq_len 64, LAYOUT_GEN greedy tokens
    per prompt): (tokens, expert load, the logits each step sampled from,
    per active slot, or None, the engine)."""
    eng = engine_cls(model, params, n_slots=n_slots, chunk_size=LAYOUT_CHUNK, max_seq_len=LAYOUT_MAX_SEQ,
                     mesh=mesh)
    rows = []
    if logits:
        sample = eng._sample

        def keep(last, mets):
            rows.append(np.stack([_np(last[i]) for i, _ in eng.scheduler.active()]))
            return sample(last, mets)

        eng._sample = keep
    reqs = []
    for p in layout_prompts():
        r = eng.submit(p, LAYOUT_GEN, ignore_eos=True)
        while r is None:
            eng.step()
            r = eng.submit(p, LAYOUT_GEN, ignore_eos=True)
        reqs.append(r)
    while eng.scheduler.has_work:
        eng.step()
    return [list(map(int, r.output)) for r in reqs], np.asarray(eng.expert_load).copy(), rows if logits else None, eng


def layout_checks(rank, world, workdir):
    """Everything test_torch_serve_mesh_layouts.py asks of a rank: each
    LAYOUT_CASES case through the engine on the 2x4 mesh from the
    reference's params (`layout_params`, converted): tokens, loads, the
    cache's layout, and on rank 0 the logits each step sampled from."""
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatchingEngine

    mesh = make_host_mesh(*LAYOUT_MESH)
    out = {}
    for case in LAYOUT_CASES:
        cfg = layout_cfg(configs, case)
        params = params_from_numpy(layout_params(workdir, case[0]), cfg, "cpu")
        tokens, load, logits, eng = layout_stream(ContinuousBatchingEngine, Model(cfg, device="cpu"), params,
                                                  case[3], mesh, logits=rank == 0)
        out[case[0]] = {"tokens": tokens, "load": load, "logits": logits, "specs": layout_specs(eng.model.slot_specs)}
    return out


# -------------------------------------------- checkpoints, microbatches, sweep


CKPT_STEPS, CKPT_AT = 4, 2
ROLLBACK_NAN = 3  # nan_grad@step=3 under the rollback policy, a save every 2 steps


def micro_cfg(configs):
    """The reference's microbatch anchor (tests/test_train_sharded.py:466):
    reduced minimind-16e, vocab 256, topk at capacity factor 8."""
    cfg = configs.reduced_for_smoke("minimind_moe_16e", vocab_size=256)
    return dataclasses.replace(cfg, routing=dataclasses.replace(cfg.routing, strategy="topk",
                                                                capacity_factor=8.0))


def _whole(state, model, mesh):
    """The whole TrainState from every rank's blocks (a collective)."""
    from repro_torch.distributed import unshard_tree
    from repro_torch.training.loop import _state_specs

    return unshard_tree(state, _state_specs(model, state), mesh)


def _summary(state, log):
    from repro_torch.optim.adamw import tree_paths

    return {"losses": list(log.losses), "vio": np.stack(log.max_vio_steps),
            "q": np.concatenate([_np(s["q"]) for s in state.router_states if s is not None]),
            "params": {p: _np(v) for p, v in tree_paths(state.params)}}


def _step_result(state):
    """The params and AdamW's first moment of a whole TrainState, by path."""
    from repro_torch.optim.adamw import tree_paths

    return {"params": {p: _np(v) for p, v in tree_paths(state.params)},
            "mu": {p: _np(v) for p, v in tree_paths(state.opt_state["mu"])}}


def ckpt_checks(rank, world, workdir):
    """Everything test_torch_mesh_ckpt.py asks of a rank on the 4x2 mesh:
    a checkpointed and resumed bip run beside the straight one, a guarded
    rollback, microbatched steps, and the sweep's --sync cells. Then ranks
    1-4 each run one of the one-device references the test holds them to
    (`one_device`), side by side, one thread each."""
    import pickle

    from repro_torch import configs
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.convert import train_state_from_numpy, train_state_to_tree
    from repro_torch.data import SyntheticBatchStream, make_batches
    from repro_torch.distributed import make_mesh_ctx, shard_tree, train_state_specs
    from repro_torch.launch import balance_sweep
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, schedules
    from repro_torch.robustness import FaultPlan, GuardConfig
    from repro_torch.training import compile_train_step, train_loop
    from repro_torch.training.loop import micro_layout, shard_batch

    mesh = make_host_mesh(4, 2)
    out = {}
    # resume: CKPT_STEPS straight steps against CKPT_AT with a save there, then a resume
    cfg = train_cfg(configs, sync_global=True)
    model = build_model(cfg, make_mesh_ctx(mesh), device="cpu")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=CKPT_STEPS, mesh=mesh)
    stream = lambda: SyntheticBatchStream(cfg, 8, 64, CKPT_STEPS, seed=0)  # noqa: E731
    st, log = train_loop(model, stream(), **kw)
    out["straight"] = _summary(_whole(st, model, mesh), log)
    ck = str(workdir / "ck")
    st, log = train_loop(model, stream(), ckpt_dir=ck, ckpt_every=CKPT_AT, **dict(kw, total_steps=CKPT_AT))
    whole = _whole(st, model, mesh)
    out["saved"] = {k: None if v is None else _np(v) for k, v in _flatten(train_state_to_tree(whole, cfg)).items()}
    first = list(log.losses)
    st, log = train_loop(model, stream(), ckpt_dir=ck, ckpt_every=CKPT_AT, resume=True, **kw)
    out["resumed"] = _summary(_whole(st, model, mesh), log)
    out["resumed"]["losses"] = first + out["resumed"]["losses"]
    # rollback: the NaN at step 3 rolls back to step 2's checkpoint and replays
    st, log = train_loop(model, stream(), ckpt_dir=str(workdir / "ck_rb"), ckpt_every=2,
                         guard=GuardConfig(policy="rollback"),
                         faults=FaultPlan.from_specs([f"nan_grad@step={ROLLBACK_NAN}"]), **kw)
    out["rollback"] = dict(_summary(_whole(st, model, mesh), log), events=[dict(e) for e in log.events])

    # microbatches: one step of micro 1 and 2 (topk) from the reference's
    # init, on a batch whose microbatches split over the data ranks and on
    # one whose microbatches do not (replicated)
    with open(workdir / "micro_state.pkl", "rb") as f:
        micro_state = pickle.load(f)
    mcfg = micro_cfg(configs)
    mmodel = build_model(mcfg, make_mesh_ctx(mesh), device="cpu")
    opt = adamw.from_model_config(mcfg)
    for rows in (8, 4):
        batch = next(iter(make_batches(mcfg, rows, 32, 1, seed=0)))
        for k in (1, 2):
            state = train_state_from_numpy(*micro_state, mcfg, "cpu")
            specs = train_state_specs(state, mcfg, mesh)
            b_specs = micro_layout(mcfg, mesh, batch, k)
            step = compile_train_step(mmodel, opt, schedules.constant(1e-3), state, batch, mesh=mesh,
                                      microbatches=k, st_specs=specs, b_specs=b_specs)
            local, mets = step(shard_tree(state, specs, mesh), shard_batch(batch, b_specs, mesh, k))
            out[f"micro_{rows}_{k}"] = {"loss": float(mets["loss"]), "split": b_specs["tokens"][0] is not None,
                                        **_step_result(_whole(local, mmodel, mesh))}
    # bip, sync='global', two microbatches: two steps of train_loop
    st, log = train_loop(model, stream(), microbatches=2, **dict(kw, total_steps=2))
    out["micro_bip"] = _summary(_whole(st, model, mesh), log)

    # the sweep's cross-shard cells, 2 steps from the reference's init
    with open(workdir / "sweep_state.pkl", "rb") as f:
        sweep_state = pickle.load(f)
    scfg = balance_sweep.sweep_cfg("minimind_moe_16e")
    for sync in ("global", "local"):
        rec = balance_sweep.run_method(scfg, "bip", 2, lr=1e-3, sync=sync, use_kernel=False, mesh=mesh,
                                       state=train_state_from_numpy(*sweep_state, scfg, "cpu"), device="cpu")
        out[f"sweep_{sync}"] = {k: rec[k] for k in ("sync", "mesh", "max_vio_per_step", "ppl_per_step",
                                                     "first_step_max_vio")}
    out["one_device"] = one_device_reference(rank, workdir, micro_state)
    return out


def one_device_reference(rank, workdir, micro_state):
    """Rank r in 1-4 runs the r-th one-device reference of
    test_torch_mesh_ckpt.py on its own (no collective): 1 the resume from
    the mesh's step-CKPT_AT file, 2 the guarded rollback run, 3 bip with
    two microbatches, 4 one microbatched topk step from the reference's
    init. Others return None."""
    import shutil

    from repro_torch import configs
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data import SyntheticBatchStream, make_batches
    from repro_torch.models import Model
    from repro_torch.optim import adamw, schedules
    from repro_torch.robustness import FaultPlan, GuardConfig
    from repro_torch.training import make_train_step, train_loop

    cfg = train_cfg(configs, sync_global=True)
    stream = lambda: SyntheticBatchStream(cfg, 8, 64, CKPT_STEPS, seed=0)  # noqa: E731
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=CKPT_STEPS)
    if rank == 1:
        one = workdir / "ck_one_device"
        one.mkdir()
        for suffix in (".npz", ".manifest.json", ".data.json"):
            shutil.copy(workdir / "ck" / f"step_{CKPT_AT}{suffix}", one)
        st, log = train_loop(Model(cfg, device="cpu"), stream(), ckpt_dir=str(one), resume=True, **kw)
        return _summary(st, log)
    if rank == 2:
        st, log = train_loop(Model(cfg, device="cpu"), stream(), ckpt_dir=str(workdir / "ck_rb_one"), ckpt_every=2,
                             guard=GuardConfig(policy="rollback"),
                             faults=FaultPlan.from_specs([f"nan_grad@step={ROLLBACK_NAN}"]), **kw)
        return dict(_summary(st, log), events=[dict(e) for e in log.events])
    if rank == 3:
        st, log = train_loop(Model(cfg, device="cpu"), stream(), microbatches=2, **dict(kw, total_steps=2))
        return _summary(st, log)
    if rank == 4:
        mcfg = micro_cfg(configs)
        state = train_state_from_numpy(*micro_state, mcfg, "cpu")
        step = make_train_step(Model(mcfg, device="cpu"), adamw.from_model_config(mcfg),
                               schedules.constant(1e-3), microbatches=2)
        state, mets = step(state, next(iter(make_batches(mcfg, 8, 32, 1, seed=0))))
        return {"loss": float(mets["loss"]), **_step_result(state)}
    return None
