"""Balance-method sweep of the port: the paper's method comparison (Tables
2-5 quantities) through the port's training harness, on the GPU unless
--device cpu. The counterpart of the reference's benchmarks/balance_sweep.py.

    PYTHONPATH=src python -m repro_torch.launch.balance_sweep --device cpu --smoke \
        --steps 4 --out sweep.json                         # reduced, CPU
    PYTHONPATH=src python -m repro_torch.launch.balance_sweep --full-width \
        --steps 12 --repeats 2 --out sweep.json            # the paper's four, H100
    PYTHONPATH=src python -m repro_torch.launch.balance_sweep --full-width --matrix \
        --steps 12 --out matrix.json                       # all seven methods, H100

For minimind-moe-16e and 64e and each routing method (the paper's four:
bip, lossfree, aux_loss, topk; with --matrix or --methods also phi, lpr
and expert_choice), every method trains the SAME token stream from the
SAME init through `training.train_loop`, recording per step the per-layer
MaxVio, the training perplexity and the step time; at the end AvgMaxVio,
SupMaxVio, the first step's MaxVio, the final ppl and the steady step
p50/p99, plus each kernel's launches in the run.

Geometry: on the GPU the real configs at batch 16 x 512 (--full-width, the
default there). On the CPU the reference's (reduced width and depth at the
real expert counts for the sweep, full depth with reduced narrow dims for
the matrix; batch 8 x 64); --reduced forces the sweep's smoke geometry on
either device. The expert FFN runs through K1/K2 and bip's dual update
through K3 (use_kernel=True; their plain versions on the CPU). In matrix
mode bip also re-runs under sync='global' on the plain bisection solver
(K3 off, K1/K2 on); the other methods' global cells are copies of their
local cells (on one device the cross-shard reductions are no-ops), as in
the reference.

--data swaps the synthetic stream for the real-text pipeline (tokenizer
trained once per vocab size on the corpus, or loaded from --tokenizer,
then the sharded loader and the prefetcher); --repeats 2 runs the methods
in order, then in reverse order, and reports each method's steady step
p50 per pass, so a difference between methods can be told from drift.
Results go to --out only; a path named BENCH_*.json is refused (those are
the reference's records).

--sync local|global|both switches to the CROSS-SHARD lens (the
reference's BENCH_balance_sweep_sync.json): BIP trains on a --mesh DxM
mesh (default 4x2) under each requested dual-sync mode, beside the
unsharded single-device cell (sync='global': the threshold solver, so the
contrast is solver for solver), on the same init and token stream; every
entry records its sync mode and mesh. The duals run on the threshold
bisection (K3 off; psum'd counts on the mesh), the expert FFN on K1/K2.
It runs one process per rank:

    python -m torch.distributed.run --nproc-per-node 8 -m repro_torch.launch.balance_sweep \
        --sync both --mesh 4x2 --device cpu --steps 80 --out sync.json

Rank 0 runs the single-device cell (the other ranks wait for it at the
mesh cells' first collective), prints, and writes --out.
"""
from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

# the paper's four; --matrix adds the registry's other methods
METHODS = ("bip", "lossfree", "aux_loss", "topk")
MATRIX_METHODS = ("bip", "lossfree", "aux_loss", "topk", "phi", "lpr", "expert_choice")
ARCHS = ("minimind_moe_16e", "minimind_moe_64e")

# the reference's reduced sweep geometry (batch*seq = 512 tokens per step)
BATCH, SEQ_LEN = 8, 64
# full width: the training shape of chip_smoke.py (8192 routed tokens/layer)
FULL_BATCH, FULL_SEQ = 16, 512

# the cross-shard lens's mesh when --mesh is not given (the reference's)
SYNC_MESH = (4, 2)


def sweep_cfg(arch: str):
    """Reduced (smoke depth and width) config with the REAL routing table."""
    from repro_torch import configs

    return configs.reduced_for_smoke(arch, routing=configs.get(arch).routing)


def matrix_cfg(arch: str):
    """The real depth (n_layers, d_model) and routing table; the narrow dims
    (heads, expert hidden, vocab) reduced, as the reference's matrix."""
    from repro_torch import configs

    full = configs.get(arch)
    return configs.reduced_for_smoke(arch, routing=full.routing, n_layers=full.n_layers,
                                     d_model=full.d_model)


def full_cfg(arch: str):
    """The real config at full width."""
    from repro_torch import configs

    return configs.get(arch)


def resolve_methods(spec: Optional[str], default: Sequence[str]) -> tuple:
    """--methods csv -> tuple, each name validated against the registry."""
    from repro_torch.core import get_balancer

    if not spec:
        return tuple(default)
    methods = tuple(s.strip() for s in spec.split(",") if s.strip())
    for name in methods:
        get_balancer(name)  # raises ValueError listing the registered names
    return methods


def check_out_path(path: Optional[str]) -> None:
    """Refuse to write over the reference's records (BENCH_*.json)."""
    if path and fnmatch.fnmatch(os.path.basename(path), "BENCH_*.json"):
        raise ValueError(f"refusing to write {path}: BENCH_*.json files are the reference's "
                         f"records; pass another --out")


_TOKENIZERS: Dict[tuple, Any] = {}


def get_tokenizer(data: str, tokenizer_path: Optional[str], vocab_size: int):
    """Load --tokenizer when the file exists, else train one on the corpus
    (cached per corpus and vocab size, so 16e and 64e share it)."""
    from repro_torch.data import ByteBPETokenizer, resolve_shards, train_tokenizer_from_files

    if tokenizer_path and os.path.exists(tokenizer_path):
        tok = ByteBPETokenizer.load(tokenizer_path)
        if tok.vocab_size > vocab_size:
            raise ValueError(f"tokenizer vocab {tok.vocab_size} exceeds model vocab {vocab_size}")
        return tok
    key = (data, vocab_size)
    if key not in _TOKENIZERS:
        _TOKENIZERS[key] = train_tokenizer_from_files(resolve_shards(data), vocab_size=vocab_size)
        if tokenizer_path:
            _TOKENIZERS[key].save(tokenizer_path)
    return _TOKENIZERS[key]


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import bip_admm, flash_attn, moe_gemm

    return {"K1": moe_gemm.grouped_gated_ffn_in.launches, "K2": moe_gemm.grouped_matmul.launches,
            "K3": bip_admm.bip_dual_update.launches + bip_admm.bip_admm_iteration.launches,
            "K4": flash_attn.flash_attention.launches, "K4_bwd": flash_attn.flash_attention.bwd_launches}


def _reset_launch_counts() -> None:
    from repro_torch.kernels import bip_admm, flash_attn, moe_gemm

    moe_gemm.reset_launch_counts()
    bip_admm.reset_launch_counts()
    flash_attn.reset_launch_counts()


def run_method(
    cfg,
    method: str,
    steps: int,
    *,
    lr: float = 1e-3,
    warmup_steps: Optional[int] = None,
    batch: int = BATCH,
    seq_len: int = SEQ_LEN,
    microbatches: int = 1,
    data: Optional[str] = None,
    tokenizer_path: Optional[str] = None,
    pack_mode: str = "pack",
    sync: Optional[str] = None,
    use_kernel: Optional[bool] = None,
    ffn_kernel: Optional[bool] = None,
    bip_iters: Optional[int] = None,
    state=None,
    test_batches: int = 0,
    device="cuda",
    seed: int = 0,
    mesh=None,
) -> Dict[str, Any]:
    """Train `method` on `cfg` for `steps` steps and return its record (the
    reference's keys: max_vio_per_step, ppl_per_step, step_time_s,
    first_step_max_vio, train_wall_s and TrainLog.summary(), plus
    loss_per_step, the kernels' launches in the run and, with
    test_batches, test_ppl on that many held-out synthetic batches).

    Every call builds a fresh Model: the same init (from `seed`, or the
    TrainState `state`, e.g. the reference's init through
    convert.train_state_from_numpy) and the same stream (synthetic from
    `seed`, or `data` through the loader with seed 0) for every method.
    `sync`, `use_kernel`, `ffn_kernel` and `bip_iters` override the
    config's routing where given. `mesh` (a DeviceMesh; every rank calls
    this with the same arguments) trains on it, the model laid out by
    distributed.make_mesh_ctx, and the record names its sync mode and
    shape."""
    from repro_torch import resolve_device
    from repro_torch.data import SyntheticBatchStream, make_batches
    from repro_torch.distributed import make_mesh_ctx
    from repro_torch.models import build_model
    from repro_torch.training import evaluate_ppl, train_loop

    over = {"strategy": method}
    for name, val in (("sync", sync), ("use_kernel", use_kernel), ("ffn_kernel", ffn_kernel),
                      ("bip_iters", bip_iters)):
        if val is not None:
            over[name] = val
    cfg = dataclasses.replace(cfg, routing=dataclasses.replace(cfg.routing, **over))
    device = resolve_device(device)
    model = build_model(cfg, make_mesh_ctx(mesh), device=device)
    if data:
        from repro_torch.data import Prefetcher, ShardedTextLoader, resolve_shards

        tok = get_tokenizer(data, tokenizer_path, cfg.vocab_size)
        loader = ShardedTextLoader(resolve_shards(data), tok, batch_size=batch, seq_len=seq_len,
                                   pack_mode=pack_mode, seed=0)
        batches = Prefetcher(loader, device=device if device.type == "cuda" else None)
    else:
        batches = SyntheticBatchStream(cfg, batch, seq_len, steps, seed=seed, device=device)
    _reset_launch_counts()
    t0 = time.perf_counter()
    state, log = train_loop(model, batches, seed=seed, lr=lr,
                            warmup_steps=max(steps // 10, 1) if warmup_steps is None else warmup_steps,
                            total_steps=steps, state=state, microbatches=microbatches, mesh=mesh)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    vio = log.max_vio_steps
    if mesh is not None:
        sync_label = cfg.routing.sync
    elif cfg.routing.sync == "global":
        sync_label = "n/a (single device, threshold solver: sync='global')"
    else:
        sync_label = "n/a (single device)"
    rec = {
        "strategy": method,
        "sync": sync_label,
        "mesh": None if mesh is None else list(mesh.shape),
        "use_kernel": cfg.routing.use_kernel,
        "ffn_kernel": cfg.routing.use_kernel if cfg.routing.ffn_kernel is None else cfg.routing.ffn_kernel,
        "max_vio_per_step": [[float(v) for v in row] for row in vio],
        "ppl_per_step": list(log.perplexities),
        "loss_per_step": list(log.losses),
        "step_time_s": list(log.step_times),
        "first_step_max_vio": float(vio[0].max()) if vio else None,
        "train_wall_s": wall,
        "launches": launches,
        **log.summary(),
    }
    if test_batches:
        test = make_batches(cfg, batch, seq_len, test_batches, seed=seed, split="test", device=device)
        rec["test_ppl"] = evaluate_ppl(model, state, test)
    del model, state
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()  # free this model before the next one
    return rec


def _row(name: str, rec: Dict[str, Any]) -> Dict[str, Any]:
    """One line of the reference's CSV contract: name,us_per_call,derived."""
    step_s = rec["mean_step_time"] or (sum(rec["step_time_s"]) / max(len(rec["step_time_s"]), 1))
    step0 = rec["first_step_max_vio"]
    return {
        "name": name,
        "us_per_call": step_s * 1e6,
        "derived": (f"AvgMaxVio={rec['AvgMaxVio']:.4f};SupMaxVio={rec['SupMaxVio']:.4f};"
                    f"step0MaxVio={step0 if step0 is None else round(step0, 4)};"
                    f"ppl={rec['final_ppl']:.1f}"),
    }


def _geometry(mode: str, full_width: bool, reduced: bool, device):
    """(config function, batch, seq_len) for a run mode ('sweep'/'matrix'):
    full width when asked for, or on a CUDA device unless `reduced`."""
    if full_width or (device.type == "cuda" and not reduced):
        return full_cfg, FULL_BATCH, FULL_SEQ
    if reduced or mode == "sweep":
        return sweep_cfg, BATCH, SEQ_LEN
    return matrix_cfg, BATCH, SEQ_LEN


def run(
    smoke: bool = False,
    steps: int = 0,
    data: Optional[str] = None,
    tokenizer_path: Optional[str] = None,
    pack_mode: str = "pack",
    methods: Sequence[str] = METHODS,
    full_width: bool = False,
    reduced: bool = False,
    repeats: int = 1,
    device="cuda",
    sync: Optional[str] = None,
    mesh=None,
) -> Dict[str, Any]:
    """The method sweep: every method per config on one stream. Returns
    {'meta', 'configs': {name: {..., 'methods': {method: record}}}, 'rows'};
    with repeats > 1, pass r runs the methods in order (r even) or reversed
    (r odd) and 'p50_per_pass' holds each method's steady step p50 per
    pass (the records are the first pass's).

    `sync` ('local', 'global' or 'both') with `mesh` (a DeviceMesh; every
    rank calls this) runs the cross-shard lens instead: 'bip[single-device]'
    (sync='global', no mesh: on rank 0 only) and 'bip[sync=<mode>]' on the
    mesh, the duals on the threshold solver, as the reference's."""
    from repro_torch import resolve_device

    steps = steps or (12 if smoke else 80)
    device = resolve_device(device)
    build, batch, seq_len = _geometry("sweep", full_width, reduced, device)
    full_width = build is full_cfg
    sync_modes = None if sync is None else (["local", "global"] if sync == "both" else [sync])
    lead = True
    if sync_modes:
        import torch.distributed as dist

        methods, repeats, lead = ("bip",), 1, dist.get_rank() == 0
    note = "identical init + token stream per method; MaxVio = max_load/mean_load - 1 per MoE layer per batch"
    out: Dict[str, Any] = {
        "meta": {"batch": batch, "seq_len": seq_len, "steps": steps, "data": data,
                 "pack_mode": pack_mode if data else None,
                 "full_width": full_width, "repeats": repeats, "device": str(device),
                 "mesh": list(mesh.shape) if sync_modes else None,
                 "note": note + ("; cross-shard sync sweep: BIP on a DxM mesh per sync mode vs the unsharded "
                                 "single-device reference" if sync_modes else "; single device")},
        "configs": {},
        "rows": [],
    }
    for arch in ARCHS:
        cfg = build(arch)
        entry: Dict[str, Any] = {
            "n_experts": cfg.routing.n_experts, "top_k": cfg.routing.top_k,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model, "bip_iters": cfg.routing.bip_iters,
            "methods": {}, "p50_per_pass": {m: [] for m in methods},
        }
        kw = dict(batch=batch, seq_len=seq_len, data=data, tokenizer_path=tokenizer_path,
                  pack_mode=pack_mode, device=device)
        if sync_modes:
            # the duals on the threshold solver in every cell (K3 off, K1/K2 on)
            cells = ([("bip[single-device]", None, "global")] if lead else []) + [
                (f"bip[sync={sm}]", mesh, sm) for sm in sync_modes]
            for label, msh, sm in cells:
                rec = run_method(cfg, "bip", steps, sync=sm, use_kernel=False, ffn_kernel=True, mesh=msh, **kw)
                entry["methods"][label] = rec
                out["rows"].append(_row(f"balance_sweep_{cfg.name}_{label}_sync", rec))
                if lead:
                    print(f"  {cfg.name} {label:18s} AvgMaxVio={rec['AvgMaxVio']:.4f} "
                          f"step0={rec['first_step_max_vio']:.4f} ppl={rec['final_ppl']:.2f} "
                          f"p50={_ms(rec['step_time_p50'])}", flush=True)
            del entry["p50_per_pass"]
            out["configs"][cfg.name] = entry
            continue
        for r in range(repeats):
            for method in (methods if r % 2 == 0 else tuple(reversed(methods))):
                rec = run_method(cfg, method, steps, use_kernel=True, **kw)
                entry["p50_per_pass"][method].append(rec["step_time_p50"])
                if r:
                    continue
                entry["methods"][method] = rec
                out["rows"].append(_row(f"balance_sweep_{cfg.name}_{method}{'_data' if data else ''}",
                                        rec))
                print(f"  {cfg.name} {method:14s} AvgMaxVio={rec['AvgMaxVio']:.4f} "
                      f"step0={rec['first_step_max_vio']:.4f} ppl={rec['final_ppl']:.1f} "
                      f"p50={_ms(rec['step_time_p50'])} launches={rec['launches']}", flush=True)
        if repeats > 1:
            for method, p50s in entry["p50_per_pass"].items():
                print(f"  {cfg.name} {method:14s} steady p50 per pass: {[_ms(p) for p in p50s]}")
        out["configs"][cfg.name] = entry
    return out


def _ms(seconds: Optional[float]) -> str:
    return "n/a" if seconds is None else f"{1e3 * seconds:.2f} ms"


def router_level_compare(
    methods: Sequence[str] = ("bip", "expert_choice"),
    n: int = 256,
    m: int = 8,
    k: int = 2,
    skew: float = 1.5,
    seeds: Sequence[int] = (0, 1, 2),
    device="cuda",
) -> List[Dict[str, Any]]:
    """One gate on skewed score streams against the LP oracle: every method
    through the registry-backed `route()` (the training path's call) on
    softmax scores with an expert-popularity skew, on `device`, beside the
    LP optimum solved on the host. Per method: routed objective / LP
    optimum, MaxVio, and coverage (share of tokens with all k / no
    experts). The name 'bip[kernel]' in `methods` asks for bip with its
    dual update through K3 (its plain version on the CPU) beside plain
    'bip'. Each row names the device its scores were routed on."""
    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import RouterConfig, init_router_state, route
    from repro_torch.core.lp_oracle import solve_plp

    device = resolve_device(device)
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        logits = torch.from_numpy(
            (rng.standard_normal((n, m)) + skew * np.linspace(2, -2, m)[None, :]).astype(np.float32)
        ).to(device)
        s = torch.softmax(logits, dim=-1)
        _, lp_opt = solve_plp(s, k)
        row: Dict[str, Any] = {"seed": seed, "lp_opt": float(lp_opt), "device": str(logits.device),
                               "methods": {}}
        for label in methods:
            method = label.split("[")[0]
            cfg = RouterConfig(n_experts=m, top_k=k, strategy=method, bip_iters=8,
                               use_kernel=label.endswith("[kernel]") and method == "bip")
            out = route(logits, init_router_state(cfg, device), cfg)
            idx = out.expert_index.cpu().numpy()
            per_token = (idx < m).sum(axis=-1)
            # combine weights are the raw scores of the kept selections (zero
            # on expert_choice's sentinel slots): their sum is the objective
            row["methods"][label] = {
                "obj_ratio": float(out.combine_weights.sum()) / lp_opt,
                "max_vio": float(out.metrics["max_vio"]),
                "coverage_full": float(np.mean(per_token >= k)),
                "coverage_zero": float(np.mean(per_token == 0)),
            }
        rows.append(row)
    return rows


def aggregate_router_level(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Mean over seeds, per method."""
    import numpy as np

    return {
        method: {col: float(np.mean([r["methods"][method][col] for r in rows]))
                 for col in rows[0]["methods"][method]}
        for method in rows[0]["methods"]
    }


def run_matrix(
    smoke: bool = False,
    steps: int = 0,
    data: Optional[str] = None,
    tokenizer_path: Optional[str] = None,
    pack_mode: str = "pack",
    methods: Sequence[str] = MATRIX_METHODS,
    full_width: bool = False,
    reduced: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """The all-method matrix: method x config x {synthetic, real text} x
    {local, global sync}, single device. sync='global' changes only bip (the
    plain bisection dual instead of the sort-based or K3 one), so bip's
    global cell re-runs with use_kernel=False (K1/K2 kept through
    ffn_kernel) and the other global cells copy their local record with a
    note. Real text runs on `data`, or on tests/fixtures/corpus where it
    exists (as the reference)."""
    from repro_torch import resolve_device

    steps = steps or (4 if smoke else 24)
    methods = resolve_methods(",".join(methods), MATRIX_METHODS)
    if data is None and os.path.isdir("tests/fixtures/corpus"):
        data = "tests/fixtures/corpus"
    device = resolve_device(device)
    build, batch, seq_len = _geometry("sweep" if smoke else "matrix", full_width, reduced, device)
    full_width = build is full_cfg
    out: Dict[str, Any] = {
        "meta": {"batch": batch, "seq_len": seq_len, "steps": steps, "smoke": smoke, "data": data,
                 "pack_mode": pack_mode if data else None, "methods": list(methods),
                 "full_width": full_width, "device": str(device),
                 "note": "identical init + token stream per cell; single device, so sync='global' "
                         "re-runs only bip (the dual solver changes); the other global cells copy "
                         "the local record"},
        "router_level": aggregate_router_level(router_level_compare(methods=methods, device=device)),
        "configs": {},
        "rows": [],
    }
    modes = [("synthetic", None)] + ([("real_text", data)] if data else [])
    for arch in ARCHS:
        cfg = build(arch)
        entry: Dict[str, Any] = {
            "n_experts": cfg.routing.n_experts, "top_k": cfg.routing.top_k,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model, "bip_iters": cfg.routing.bip_iters,
            "cells": {},
        }
        kw = dict(batch=batch, seq_len=seq_len, tokenizer_path=tokenizer_path, pack_mode=pack_mode,
                  device=device)
        for mode, mode_data in modes:
            for method in methods:
                rec = run_method(cfg, method, steps, data=mode_data, sync="local",
                                 use_kernel=True, **kw)
                if method == "bip":
                    rec_g = run_method(cfg, method, steps, data=mode_data, sync="global",
                                       use_kernel=False, ffn_kernel=True, **kw)
                else:
                    rec_g = dict(rec, note="copied from the local cell: single-device trajectory "
                                           "is identical under either sync mode for this method")
                for sync, r in (("local", rec), ("global", rec_g)):
                    entry["cells"][f"{mode}/{sync}/{method}"] = r
                    out["rows"].append(_row(f"balance_matrix_{cfg.name}_{mode}_{sync}_{method}", r))
                print(f"  {cfg.name} {mode:9s} {method:14s} AvgMaxVio={rec['AvgMaxVio']:.4f} "
                      f"ppl={rec['final_ppl']:.1f} p50={_ms(rec['step_time_p50'])}", flush=True)
        out["configs"][cfg.name] = entry
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="few steps (12; 4 with --matrix)")
    ap.add_argument("--steps", type=int, default=0, help="override the step count")
    ap.add_argument("--data", default=None,
                    help="corpus dir/glob: train on real text through the data pipeline")
    ap.add_argument("--tokenizer", default=None, help="tokenizer JSON (trained on --data if missing)")
    ap.add_argument("--pack-mode", default="pack", choices=["pack", "pack_nocross", "pad"])
    ap.add_argument("--methods", default=None,
                    help="comma-separated registered balancers (default: the paper's four; "
                         "--matrix: all seven)")
    ap.add_argument("--matrix", action="store_true", help="the all-method matrix (see the module doc)")
    ap.add_argument("--device", default="cuda", help="'cpu' runs without a GPU")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's smoke geometry (on the CPU the default is the reference's)")
    ap.add_argument("--full-width", action="store_true",
                    help=f"the real configs, batch {FULL_BATCH} x {FULL_SEQ} (the default on the GPU)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="passes over the methods, alternating order (sweep mode)")
    ap.add_argument("--out", default=None, help="write the results JSON here (not BENCH_*.json)")
    ap.add_argument("--sync", default=None, choices=["local", "global", "both"],
                    help="the cross-shard lens: bip on --mesh per sync mode beside the single-device "
                         "cell (under torch.distributed.run)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help=f"the cross-shard lens's mesh (default {SYNC_MESH[0]}x{SYNC_MESH[1]})")
    args = ap.parse_args(argv)
    if args.mesh and not args.sync:
        ap.error("--mesh only applies to --sync runs (the method sweep is single-device by design)")
    if args.matrix and args.sync:
        ap.error("--matrix and --sync are separate lenses; the matrix is single-device")
    if args.reduced and args.full_width:
        ap.error("--reduced and --full-width are exclusive")
    if args.repeats < 1:
        ap.error("--repeats must be >= 1")
    try:
        check_out_path(args.out)
        methods = resolve_methods(args.methods, MATRIX_METHODS if args.matrix else METHODS)
    except ValueError as e:
        ap.error(str(e))
    device, mesh, lead = args.device, None, True
    if args.sync:
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_from_cli

        mesh, device = mesh_from_cli(ap, args.mesh or "x".join(map(str, SYNC_MESH)), args.device)
        lead = dist.get_rank() == 0
    common = dict(smoke=args.smoke, steps=args.steps, data=args.data, tokenizer_path=args.tokenizer,
                  pack_mode=args.pack_mode, methods=methods, full_width=args.full_width,
                  reduced=args.reduced, device=device)
    if args.matrix:
        result = run_matrix(**common)
    else:
        result = run(repeats=args.repeats, sync=args.sync, mesh=mesh, **common)
    if mesh is not None:
        dist.destroy_process_group()
    if not lead:
        return 0
    for r in result["rows"]:
        print(f"{r['name']},{r['us_per_call']},{r['derived']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=float)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
