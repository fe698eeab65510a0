"""Shared harness of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_train_mesh.py): a pool of gloo ranks on the CPU and the
reference's forced 8-device subprocess, run side by side. Not collected by
pytest (no test_ prefix).

The ranks are spawned processes (torch.multiprocessing, spawn) joined by a
file:// store in the test's temporary directory, so no TCP port is taken
and parallel test workers never collide; each runs one thread of torch.
The reference runs through tests/_forced_devices.run_code (jax on 8 forced
host devices) in a thread of the test process, at the same time."""
from __future__ import annotations

import os
import pickle
import threading
import traceback
from pathlib import Path

import torch.multiprocessing as mp

from _forced_devices import run_code


def _rank_entry(rank, world, workdir, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, world, Path(workdir), *args)
    except Exception:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def run_ranks(fn, world: int, workdir: Path, *args):
    """Run fn(rank, world, workdir, *args) in `world` gloo ranks; returns
    the per-rank results (fn's return values, pickled by the ranks).
    `fn` must be importable by module path (a module-level function)."""
    mp.start_processes(_rank_entry, args=(world, str(workdir), fn, args), nprocs=world,
                       start_method="spawn", join=True)
    outs = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out = pickle.load(f)
        if isinstance(out, dict) and "error" in out:
            raise AssertionError(f"rank {r} failed:\n{out['error']}")
        outs.append(out)
    return outs


def alongside(code: str, ranks):
    """Run the reference's forced-device `code` in a thread while `ranks()`
    runs here; returns ranks()'s value once both have finished."""
    err = []

    def ref():
        try:
            run_code(code, timeout=600)
        except BaseException as e:  # re-raised in the test's thread below
            err.append(e)

    t = threading.Thread(target=ref)
    t.start()
    try:
        out = ranks()
    finally:
        t.join()
    if err:
        raise err[0]
    return out
