"""Helpers for holding the port's cross-shard balance sweep
(`repro_torch.launch.balance_sweep --sync`) against the reference's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/sweep_sync_record.py init DIR
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 8 \
        tests/sweep_sync_record.py sweep DIR OUT.json [STEPS]
    python tests/sweep_sync_record.py compare PORT.json REF.json [RECORD.json]

`init` writes the reference's initial TrainState of the sweep's configs as
reference checkpoints, DIR/<config name>/step_0.npz: the init that the
reference's `benchmarks/balance_sweep._run_method` trains from (its
`_sweep_cfg`, key PRNGKey(0)), through the reference's own writer.
`sweep` runs the port's `--sync both` cells on the 4x2 mesh (the
`balance_sweep.run_method` calls of `balance_sweep.run`) with every cell
starting from that init (`run_method(state=)`, read by the port's
checkpoint reader), STEPS steps (default 80) at the sweep's geometry on
the CPU; rank 0 writes OUT.json in the sweep's layout. `compare` prints,
per config and cell, the AvgMaxVio, SupMaxVio, step-0 MaxVio and final
perplexity of each file and the first step at which the port's per-layer
MaxVio parts from each other file's by more than 1e-4 and its perplexity
by more than 1e-3 relative.

Not a test (no test_ prefix): `init` imports the reference package, so it
runs where jax does, beside the port's CPU tests; `sweep` imports only
the port.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def init(out_dir: str) -> None:
    import jax

    from benchmarks import balance_sweep as ref_sweep
    from repro.checkpoint import CheckpointManager
    from repro.models import build_model
    from repro.optim.adamw import from_model_config
    from repro.training.loop import init_train_state

    for arch in ("minimind_moe_16e", "minimind_moe_64e"):
        cfg = ref_sweep._sweep_cfg(arch)
        state = init_train_state(build_model(cfg), jax.random.PRNGKey(0), from_model_config(cfg))
        path = CheckpointManager(os.path.join(out_dir, cfg.name)).save_train_state(state)
        print(f"{cfg.name} -> {path}")


def sweep(init_dir: str, out: str, steps: str = "80") -> None:
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import balance_sweep as sw
    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    init_distributed("cpu")
    mesh = make_host_mesh(*sw.SYNC_MESH)
    lead = dist.get_rank() == 0
    result = {"meta": {"batch": sw.BATCH, "seq_len": sw.SEQ_LEN, "steps": int(steps), "mesh": list(sw.SYNC_MESH),
                       "init": "the reference's PRNGKey(0) init (sweep_sync_record.py init)"}, "configs": {}}
    for arch in sw.ARCHS:
        cfg = sw.sweep_cfg(arch)
        cells = ([("bip[single-device]", None, "global")] if lead else []) + [
            (f"bip[sync={sync}]", mesh, sync) for sync in ("local", "global")]
        methods = {}
        for label, msh, sync in cells:  # a fresh state per cell: a run updates its state in place
            state = CheckpointManager(os.path.join(init_dir, cfg.name)).restore_train_state(cfg, device="cpu")[1]
            methods[label] = sw.run_method(cfg, "bip", int(steps), sync=sync, use_kernel=False, ffn_kernel=True,
                                           mesh=msh, state=state, device="cpu")
            if lead:
                rec = methods[label]
                print(f"{cfg.name} {label}: AvgMaxVio {rec['AvgMaxVio']:.4f} final ppl {rec['final_ppl']:.2f}",
                      flush=True)
        result["configs"][cfg.name] = {"methods": methods}
    if lead:
        with open(out, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def _first_part(a, b, tol, relative=False):
    """(first step, largest gap, mean gap) of the per-step gap between two
    trajectories (the worst layer's where they are per layer)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    gap = np.abs(a - b) / (np.abs(b) if relative else 1.0)
    if gap.ndim > 1:
        gap = gap.max(axis=1)
    over = np.nonzero(gap > tol)[0]
    return (int(over[0]) if over.size else None), float(gap.max()), float(gap.mean())


def compare(port_path: str, *others: str) -> None:
    files = [json.load(open(p)) for p in (port_path, *others)]
    port = files[0]
    for name, entry in port["configs"].items():
        for cell, rec in entry["methods"].items():
            line = [f"{name} {cell}:"]
            for path, f in zip((port_path, *others), files):
                o = f["configs"][name]["methods"][cell]
                line.append(f"{os.path.basename(path)} AvgMaxVio {o['AvgMaxVio']:.4f} SupMaxVio {o['SupMaxVio']:.4f} "
                            f"step0 {o['first_step_max_vio']:.4f} final ppl {o['final_ppl']:.2f}")
                if f is not port:
                    v = _first_part(rec["max_vio_per_step"], o["max_vio_per_step"], 1e-4)
                    p = _first_part(rec["ppl_per_step"], o["ppl_per_step"], 1e-3, relative=True)
                    line.append(f"  MaxVio parts at step {v[0]} (largest gap {v[1]:.4f}, mean {v[2]:.4f}), "
                                f"ppl at step {p[0]} (largest {p[1]:.2e})")
            print("\n  ".join(line))
        for path, f in zip((port_path, *others), files):
            cells = f["configs"][name]["methods"]
            if "bip[sync=global]" in cells:
                v = _first_part(cells["bip[sync=global]"]["max_vio_per_step"],
                                cells["bip[single-device]"]["max_vio_per_step"], 1e-4)
                print(f"{name} {os.path.basename(path)}: sync=global against single-device: MaxVio parts at "
                      f"step {v[0]} (largest gap {v[1]:.4f}, mean {v[2]:.4f})")


if __name__ == "__main__":
    {"init": init, "sweep": sweep, "compare": compare}[sys.argv[1]](*sys.argv[2:])
