"""Host meshes and the process group under them (port of
src/repro/launch/mesh.py::make_host_mesh).

The port runs a mesh as one process per rank (`python -m
torch.distributed.run --nproc-per-node N ...`, or processes a test spawns).

    init_distributed(device)        start the process group from the
                                    launcher's environment; returns this
                                    rank's device
    make_host_mesh(data, model)     a (data, model) DeviceMesh over the ranks

Rank r sits at mesh coordinate (r // model, r % model), the row-major
layout of the reference's `np.array(devices).reshape(data, model)`.

The reference's `make_production_mesh` (TPU pods of 16x16 and 2x16x16
chips) and its TPU hardware constants are not ported: they describe TPU
hardware.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(device="cuda", *, backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> torch.device:
    """Start the default process group and bind this rank's device.

    Rank, world size and local rank come from the launcher's environment
    (RANK, WORLD_SIZE, LOCAL_RANK) unless given. On "cuda" a rank takes
    cuda:{local_rank % device_count} and the backend is NCCL when every
    rank of the host has a card of its own, gloo when ranks share cards; on
    the CPU it is gloo. `init_method` defaults to the launcher's env://
    (MASTER_ADDR/MASTER_PORT); a file:// store in a temporary directory
    needs no port. The device is set before any mesh is built, so
    DeviceMesh keeps it."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        torch.cuda.init()
        if backend is None:
            backend = "nccl" if local_world <= n_cards else "gloo"
    elif backend is None:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return dev


def make_host_mesh(data: int = 1, model: int = 1):
    """A DeviceMesh of shape (data, model) named ("data", "model") over the
    ranks of the default process group, rank r at (r // model, r % model),
    on "cuda" once init_distributed bound a card, else on "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if data * model != dist.get_world_size():
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, "
                         f"the process group has {dist.get_world_size()}")
    device_type = "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"
    mesh = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    r = dist.get_rank()
    for name, coord in (("data", r // model), ("model", r % model)):
        grp = mesh.get_group(name)
        if mesh.get_local_rank(name) != coord or dist.get_rank(grp) != coord:
            raise RuntimeError(f"rank {r}: the mesh's {name} coordinate is {mesh.get_local_rank(name)} "
                               f"and its rank in the {name} group {dist.get_rank(grp)}, not {coord}")
    return mesh


def parse_mesh(spec: str):
    """'DxM' -> (D, M)."""
    data, model = (int(v) for v in spec.lower().split("x"))
    return data, model


def mesh_from_cli(ap, spec: str, device):
    """A launcher's `--mesh DxM`: (mesh, this rank's device) once the shape
    parses and the process runs as one of D*M ranks of
    `torch.distributed.run`; anything else is an argparse error of `ap`."""
    try:
        data, model = parse_mesh(spec)
    except ValueError:
        ap.error(f"--mesh {spec!r}: expected DxM, e.g. 2x2")
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        ap.error(f"--mesh {spec} runs one process per rank: launch it with "
                 f"python -m torch.distributed.run --nproc-per-node {data * model} -m ...")
    if int(os.environ["WORLD_SIZE"]) != data * model:
        ap.error(f"--mesh {spec} needs {data * model} ranks, torch.distributed.run started "
                 f"{os.environ['WORLD_SIZE']}")
    dev = init_distributed(device)
    return make_host_mesh(data, model), dev


__all__ = ["init_distributed", "make_host_mesh", "mesh_from_cli", "parse_mesh"]
