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
