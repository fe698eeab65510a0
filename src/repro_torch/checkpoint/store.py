"""Checkpoints of the port in the reference's npz format (port of
src/repro/checkpoint/store.py, rewritten for torch on the same files).

The format: a tree flattened to an .npz whose leaves are stored as `a{i}`
under `|`-joined 'd:'/'l:'/'t:' paths (dict keys sorted), with a
`__meta__` JSON entry holding each leaf's path, dtype and the crc32 of its
stored bytes; bf16 is stored as a uint16 view and a None leaf as an empty
int8 array of dtype 'NoneType'. Files are written tmp + rename, and the
manager adds a `step_N.manifest.json` sidecar (file size + whole-file
crc32) and a `step_N.data.json` sidecar (the data stream's cursor), all
kept and garbage-collected as one unit. A file written by either package
restores in the other, leaf for leaf.

A TrainState is saved in the reference's layout: the port's per-layer
params, Adam moments and router states are stacked back into the
reference's per-position group stacks (`convert.train_state_to_tree`),
and the optimizer's step becomes a 0-d int32 leaf.

Async saves (`save_train_state(..., block=False)`): the port's train step
overwrites params and moments IN PLACE, so the save first takes a
snapshot on the device, on the compute stream (the stacking into the
reference layout copies every layer leaf; the rest are cloned), and
records an event there. A writer thread then copies the snapshot to
pinned host tensors `non_blocking` on a side stream that waits on that
event, waits for the copies' own event, and writes the npz while the
training loop keeps running. Saves are serialized: the next save (and
`wait()`) barriers on the previous writer. A CUDA error in the writer is
raised at the next `wait()`; there is no synchronous fallback. On CPU
tensors the snapshot is a clone taken before the call returns.

A sharded state (one rank of a mesh; `mesh=` and the state's spec tree)
is saved in the same format, whole: the save is a collective that every
rank calls at the same step, on the training thread (two threads issuing
collectives on one process group would interleave differently on
different ranks). Leaf by leaf, each leaf is gathered whole; rank 0 keeps
it and the others drop their copy at once, so beside its blocks a rank
holds one whole leaf at a time, and rank 0 the whole state. Rank 0 then
saves as above (its writer thread, gc); the other ranks write nothing.
`restore_sharded` barriers on rank 0's writer, lets rank 0 pick the step
(the newest valid one), and every rank loads that file and keeps its
blocks. So a file written on a mesh restores on one device, on another
mesh shape, and in the reference.

Integrity: every leaf's crc32 is re-checked by `load_pytree(verify=True)`,
`restore(step=None)` walks checkpoints newest-first and returns the newest
one that verifies, and `_gc` counts only manifest-valid checkpoints toward
`keep`, so a corrupt save never evicts the last good state.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_map

_SEP = "|"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (crc/size mismatch, or
    the npz itself is unreadable)."""


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{_SEP}d:{k}" if prefix else f"d:{k}"))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{tag}:{i}" if prefix else f"{tag}:{i}"))
    else:
        out[prefix or "root"] = tree  # None leaves are marked in the meta
    return out


def _stored(val) -> Tuple[np.ndarray, str]:
    """A leaf (CPU tensor or numpy array) as the array the npz stores and
    the dtype name the meta records."""
    if isinstance(val, torch.Tensor):
        t = val.detach()
        if t.device.type != "cpu":
            raise ValueError("save_pytree takes host leaves; copy device tensors first")
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.contiguous().numpy()
    else:
        arr = np.asarray(val)
    return arr, str(arr.dtype)


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's C-order bytes (the reference's `tobytes()`),
    read in place."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save_pytree(path: str, tree: Any) -> None:
    """Write `tree` (dicts/lists/tuples of host tensors, numpy arrays or
    None) in the reference's npz format, tmp + fsync + rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, meta = {}, {}
    for i, (key, val) in enumerate(_flatten(tree).items()):
        name = f"a{i}"
        if val is None:
            arrays[name] = np.zeros((0,), np.int8)
            meta[name] = {"path": key, "dtype": "NoneType"}
            continue
        arrays[name], dtype = _stored(val)
        meta[name] = {"path": key, "dtype": dtype, "crc32": _crc32(arrays[name])}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _set_path(root, parts, value):
    node = root
    for i, (tag, key) in enumerate(parts[:-1]):
        nxt_tag = parts[i + 1][0]
        k = key if tag == "d" else int(key)
        default = {} if nxt_tag == "d" else []
        if isinstance(node, dict):
            node = node.setdefault(k, default)
        else:
            while len(node) <= k:
                node.append(None)
            if node[k] is None:
                node[k] = default
            node = node[k]
    tag, key = parts[-1]
    k = key if tag == "d" else int(key)
    if isinstance(node, dict):
        node[k] = value
    else:
        while len(node) <= k:
            node.append(None)
        node[k] = value


def _fix_tuples(tree, parsed):
    tuple_paths = set()
    for parts, _ in parsed:
        for i, (tag, _key) in enumerate(parts):
            if tag == "t":
                tuple_paths.add(tuple(p[1] for p in parts[:i]))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            items = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            return tuple(items) if path in tuple_paths else items
        return node

    return walk(tree, ())


def load_pytree(path: str, verify: bool = False) -> Any:
    """Load a saved tree as CPU tensors (bf16 restored from its uint16
    view). With verify=True every leaf whose save recorded a crc32 is
    re-checked; a mismatch (or an unreadable npz) raises
    CheckpointCorruptError instead of restoring garbage."""
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            items = []
            for name, info in meta.items():
                if info["dtype"] == "NoneType":
                    items.append((info["path"], None))
                    continue
                arr = z[name]
                if verify and "crc32" in info:
                    crc = _crc32(arr)
                    if crc != info["crc32"]:
                        raise CheckpointCorruptError(
                            f"{path}: leaf {info['path']!r} crc mismatch "
                            f"(stored {info['crc32']}, computed {crc})"
                        )
                if info["dtype"] == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                items.append((info["path"], t))
    except CheckpointCorruptError:
        raise
    except Exception as e:
        if verify:
            # zipfile/np.load-level damage (truncation, bad zip crc, ...)
            raise CheckpointCorruptError(f"{path}: unreadable npz ({e})") from e
        raise
    parsed = [([tuple(seg.split(":", 1)) for seg in key.split(_SEP)], t) for key, t in items]
    tree: Any = {} if parsed[0][0][0][0] == "d" else []
    for parts, t in parsed:
        _set_path(tree, parts, t)
    return _fix_tuples(tree, parsed)


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """All step indices with a step_N.npz present, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1))
        for f in os.listdir(ckpt_dir)
        if (m := re.match(r"step_(\d+)\.npz$", f))
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


# ------------------------------------------------------------- integrity


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while block := f.read(chunk):
            crc = zlib.crc32(block, crc)
    return crc


def _manifest_path(npz_path: str) -> str:
    return re.sub(r"\.npz$", ".manifest.json", npz_path)


def write_manifest(npz_path: str) -> str:
    """Record the finished npz's size + whole-file crc32 in an (atomic,
    fsync'd) sidecar, so later readers detect truncation/bitrot without
    parsing the archive."""
    manifest = {
        "version": 1,
        "file": os.path.basename(npz_path),
        "size": os.path.getsize(npz_path),
        "crc32": _file_crc32(npz_path),
    }
    out = _manifest_path(npz_path)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)
    return out


def manifest_valid(npz_path: str) -> Optional[bool]:
    """False on size/crc mismatch (or a missing npz), True on a match, None
    when no manifest exists (unknown: the caller decides)."""
    mpath = _manifest_path(npz_path)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            m = json.load(f)
        if os.path.getsize(npz_path) != m["size"]:
            return False
        return _file_crc32(npz_path) == m["crc32"]
    except (OSError, ValueError, KeyError):
        return False


def verify_checkpoint(npz_path: str, deep: bool = False) -> bool:
    """True when the checkpoint passes integrity checks: the manifest (a
    missing one passes) and, with deep=True, every leaf's crc32."""
    if not os.path.exists(npz_path):
        return False
    if manifest_valid(npz_path) is False:
        return False
    if deep:
        try:
            load_pytree(npz_path, verify=True)
        except CheckpointCorruptError:
            return False
    return True


# ------------------------------------------------------------- the manager


def _host_copy(snap, side: torch.cuda.Stream, rec: Dict[str, Any]):
    """The snapshot's CUDA leaves copied to pinned host tensors, non_blocking
    on `side`; records the pinned allocation's seconds in rec['pin_s']."""
    t0 = time.perf_counter()
    host = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if t.is_cuda else t,
                    snap)
    rec["pin_s"] = time.perf_counter() - t0
    with torch.cuda.stream(side):
        for dst, src in zip(_flatten(host).values(), _flatten(snap).values()):
            if src is not None and src.is_cuda:
                dst.copy_(src, non_blocking=True)
                src.record_stream(side)  # allocated on the compute stream, read here
    return host


def _gather_to_rank0(state, specs, mesh):
    """The whole TrainState on rank 0 (None on the other ranks) from every
    rank's blocks, one leaf at a time (a collective)."""
    import torch.distributed as dist

    from repro_torch.distributed import unshard_tree

    lead = dist.get_rank() == 0

    def whole(tree, spec):
        if isinstance(tree, dict):
            return {k: whole(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [whole(v, sp) for v, sp in zip(tree, spec)]
        if not isinstance(tree, torch.Tensor):
            return tree  # the optimizer's host step counter
        leaf = unshard_tree(tree, spec, mesh)
        return leaf if lead else None

    out = type(state)(params=whole(state.params, specs.params),
                      opt_state={"step": state.opt_state["step"],
                                 "mu": whole(state.opt_state["mu"], specs.opt_state["mu"]),
                                 "nu": whole(state.opt_state["nu"], specs.opt_state["nu"])},
                      router_states=whole(state.router_states, specs.router_states))
    return out if lead else None


class CheckpointManager:
    """Keeps the most recent `keep` *valid* checkpoints under
    `dir/step_N.npz` (validity = manifest size/crc; a corrupt later save
    never counts toward `keep`, so GC cannot evict the last good state).

    `saves` records each save's timings, filled in by its writer:
    'step', 'snapshot_ms' (device time of the on-device snapshot, CUDA
    events; host time on the CPU), 'call_ms' (host time the training loop
    spends in `save_train_state`), 'writer_s' (the writer's wall time), of
    it 'pin_s' (allocating the pinned buffers) and 'copy_s' (the
    device-to-host copies) on the GPU, and 'bytes' (the npz's size)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self.saves: List[Dict[str, Any]] = []
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.npz")

    def save(self, step: int, tree: Any) -> str:
        path = self._path(step)
        save_pytree(path, tree)
        write_manifest(path)
        self._gc()
        return path

    def wait(self) -> None:
        """Barrier on the in-flight async write (no-op when none)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            raise err

    def restore(self, step: Optional[int] = None) -> Tuple[int, Any]:
        """Load a checkpoint, deep-verifying integrity. With an explicit
        `step`, corruption raises CheckpointCorruptError; with step=None
        the manager walks newest -> oldest and returns the newest VALID
        checkpoint."""
        self.wait()  # an in-flight async write may hold the newest step
        if step is not None:
            return step, self._verified_load(self._path(step))
        last_err: Optional[BaseException] = None
        for s in reversed(checkpoint_steps(self.dir)):
            try:
                return s, self._verified_load(self._path(s))
            except CheckpointCorruptError as e:
                last_err = e
                warnings.warn(
                    f"checkpoint step_{s}.npz failed verification "
                    f"({e}); falling back to the previous checkpoint"
                )
        if last_err is not None:
            raise CheckpointCorruptError(f"no valid checkpoint in {self.dir}") from last_err
        raise FileNotFoundError(f"no checkpoints in {self.dir}")

    def _verified_load(self, path: str) -> Any:
        """Manifest (whole-file size+crc) check, then the leaf-crc verifying
        load: the manifest catches damage the npz layers can miss (e.g. a
        flip inside an npy member header)."""
        if manifest_valid(path) is False:
            raise CheckpointCorruptError(
                f"{path}: manifest size/crc mismatch (truncated or bit-rotted)"
            )
        return load_pytree(path, verify=True)

    # ------------------------------------------------- full training state

    def save_train_state(self, state, cfg, data_state: Optional[Dict] = None,
                         block: bool = True, *, mesh=None, specs=None) -> str:
        """Persist a port TrainState (params, Adam moments + step, router
        states) in the reference's layout under the optimizer's step, with
        `data_state` (a BatchStream cursor) in `step_N.data.json`.
        `block=False` returns after the on-device snapshot; the copy to the
        host and the write run on a writer thread (see the module doc).

        On a mesh `state` holds this rank's blocks laid out by `specs` (a
        TrainState of specs): a collective, gathered onto rank 0, which
        alone writes; its record adds 'gather_ms' (host time of the
        gather, on the training thread)."""
        from repro_torch.convert import train_state_to_tree  # lazy: import cycle

        t_call = time.perf_counter()
        self.wait()  # at most one write in flight
        step = int(state.opt_state["step"])
        path = self._path(step)
        if mesh is not None:
            t_g = time.perf_counter()
            state = _gather_to_rank0(state, specs, mesh)
            gather_ms = 1e3 * (time.perf_counter() - t_g)
            if state is None:  # not rank 0: nothing to write
                self.saves.append({"step": step, "gather_ms": gather_ms,
                                   "call_ms": 1e3 * (time.perf_counter() - t_call)})
                return path
        leaf = state.opt_state["mu"]
        while isinstance(leaf, (dict, list, tuple)):
            leaf = next(iter(leaf.values() if isinstance(leaf, dict) else leaf))
        cuda = leaf.is_cuda
        rec: Dict[str, Any] = {"step": step}
        if mesh is not None:
            rec["gather_ms"] = gather_ms
        if cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            t_snap = time.perf_counter()
        snap = train_state_to_tree(state, cfg)  # on the device: every leaf a copy
        if cuda:
            t1.record()  # on the compute stream, after the snapshot
            device = leaf.device
        else:
            rec["snapshot_ms"] = 1e3 * (time.perf_counter() - t_snap)

        box = [snap]  # the writer drops the device snapshot once it is copied
        del snap

        def write():
            try:
                t_w = time.perf_counter()
                host = box.pop()
                if cuda:
                    torch.cuda.set_device(device)  # this thread has no current device
                    side = torch.cuda.Stream(device)
                    side.wait_event(t1)
                    t_c = time.perf_counter()
                    host = _host_copy(host, side, rec)
                    done = torch.cuda.Event()
                    done.record(side)
                    done.synchronize()  # the pinned copies are complete
                    rec["copy_s"] = time.perf_counter() - t_c - rec["pin_s"]
                    rec["snapshot_ms"] = t0.elapsed_time(t1)
                save_pytree(path, host)
                write_manifest(path)
                self._write_data_state(step, data_state)
                self._gc()
                rec["writer_s"] = time.perf_counter() - t_w
                rec["bytes"] = os.path.getsize(path)
            except BaseException as e:  # re-raised at the next wait()
                self._writer_err = e

        self.saves.append(rec)
        if block:
            write()
            rec["call_ms"] = 1e3 * (time.perf_counter() - t_call)
            self.wait()  # raise what the write raised
            return path
        self._writer = threading.Thread(target=write, name=f"repro-torch-ckpt-{step}", daemon=True)
        self._writer.start()
        rec["call_ms"] = 1e3 * (time.perf_counter() - t_call)
        return path

    def _write_data_state(self, step: int, data_state: Optional[Dict]) -> None:
        if data_state is None:
            return
        tmp = os.path.join(self.dir, f".step_{step}.data.json.tmp")
        with open(tmp, "w") as f:
            json.dump(data_state, f)
            f.flush()
            os.fsync(f.fileno())  # durable before the rename publishes it
        os.replace(tmp, os.path.join(self.dir, f"step_{step}.data.json"))

    def restore_data_state(self, step: Optional[int] = None) -> Optional[Dict]:
        """The BatchStream cursor saved with `step` (None = newest), or None
        when that checkpoint carries none."""
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step}.data.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_train_state(self, cfg, step: Optional[int] = None, device="cpu"):
        """Inverse of save_train_state: (step, port TrainState on `device`)
        from the newest valid checkpoint (or `step`), every leaf at its
        saved dtype."""
        from repro_torch.convert import train_state_from_numpy  # lazy: import cycle

        step, tree = self.restore(step)
        return step, train_state_from_numpy(
            tree["params"], tree["opt_state"], tree["router_states"], cfg, device
        )

    def restore_sharded(self, cfg, mesh, step: Optional[int] = None, device="cpu"):
        """One rank's share of `restore_train_state` on a mesh (a
        collective): (step, TrainState of this rank's blocks on `device`,
        laid out by distributed.train_state_specs), or None when the
        directory holds no checkpoint. Rank 0's writer is waited for and
        every rank barriers before any lists or reads; with step=None rank
        0 picks the newest valid step (verifying it) and broadcasts it, and
        every rank reads that file and cuts its blocks on the host before
        moving them to `device` (an explicit `step` is verified on every
        rank)."""
        import torch.distributed as dist

        from repro_torch.convert import train_state_from_numpy  # lazy: import cycle
        from repro_torch.distributed import shard_tree, train_state_specs

        self.wait()
        dist.barrier()
        tree = None
        if step is None:
            pick = [None]
            if dist.get_rank() == 0:
                try:
                    pick[0], tree = self.restore()
                except FileNotFoundError:
                    pick[0] = -1
                except CheckpointCorruptError as e:
                    pick[0] = repr(e)
            dist.broadcast_object_list(pick, src=0)
            step = pick[0]
            if step == -1:
                return None
            if isinstance(step, str):
                raise CheckpointCorruptError(f"rank 0 found no valid checkpoint: {step}")
            if tree is None:  # rank 0 verified this file: the others read it as it is
                tree = load_pytree(self._path(step))
        if tree is None:
            step, tree = self.restore(step)
        whole = train_state_from_numpy(tree["params"], tree["opt_state"], tree["router_states"], cfg, "cpu")
        del tree
        local = shard_tree(whole, train_state_specs(whole, cfg, mesh), mesh)
        del whole
        to = lambda t: t.to(device)  # noqa: E731
        local.params = tree_map(to, local.params)
        local.opt_state = {"step": local.opt_state["step"], "mu": tree_map(to, local.opt_state["mu"]),
                           "nu": tree_map(to, local.opt_state["nu"])}
        local.router_states = tree_map(to, local.router_states)
        return step, local

    def _gc(self):
        """Delete checkpoints older than the newest `keep` VALID ones
        (validity: the manifest check; a missing manifest counts as valid)."""
        n_valid = 0
        for s in reversed(checkpoint_steps(self.dir)):
            path = self._path(s)
            if n_valid >= self.keep:
                os.remove(path)
                for sidecar in (
                    os.path.join(self.dir, f"step_{s}.data.json"),
                    _manifest_path(path),
                ):
                    if os.path.exists(sidecar):
                        os.remove(sidecar)
            elif manifest_valid(path) is not False:
                n_valid += 1
