"""K5: AdamW's step over every leaf at once, a hand-written CUDA kernel pair
and its plain version.

    global_norm(grads)   sqrt(sum over the leaves of sum(g^2)), fp32
    adamw_step(...)      p, mu, nu <- AdamW(p, g * scale, mu, nu), in place,
                         scale = min(clip / max(gnorm, 1e-9), 1)

On CUDA tensors both launch the kernels of `csrc/adamw_step.cu` (compiled
with nvcc for sm_90a at first use, loaded through ctypes; see nvcc.py) or
raise on what they do not take: a leaf that is not contiguous, another
dtype than float32 or bfloat16, a gradient in another dtype than its
param's or two moments of two dtypes (no configuration declares either),
leaves on more than one device, a gnorm or guard elsewhere than the
leaves. They never fall back. On CPU tensors they run the plain versions,
`global_norm_plain` and `adamw_step_plain` (the update in slices of _SLICE
elements, which bounds its fp32 temporaries without changing a bit: the
math is elementwise).

The kernels take the leaves grouped by dtypes and cut into chunks of at
most LEAVES_PER_LAUNCH (`launch_plan`, pure Python): the norm is one launch
a chunk and one that adds the chunks' partial sums; the update one launch a
chunk. Given the same gnorm the update is bit-equal to `adamw_step_plain`
on the card; the norm differs from `global_norm_plain` in its last bits
(another order of the sum, in fp64) and is the same from call to call.

Launches are counted in plain integers: `global_norm.launches` (the norm's
kernels), `adamw_step.launches` (the update's) and `adamw_step.elements`
(the elements handed to the update, whatever the guard said);
`reset_launch_counts()` zeroes them.
"""
from __future__ import annotations

import ctypes
from typing import Hashable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import nvcc

Tensor = torch.Tensor
LEAVES_PER_LAUNCH = 64  # the leaf table a launch takes by value (csrc MAX_LEAVES)
TILE = 4096  # elements a block updates (csrc TILE)
NORM_BLOCKS = 528  # blocks of a norm launch, one partial sum each (csrc NORM_BLOCKS)
# elements per slice of the plain update (256 MB of fp32): a 1e9-element
# embedding would otherwise hold ~6 fp32 temporaries of 4 GB at once
_SLICE = 1 << 26
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes
_RC = {-1: "unsupported dtype", -2: "bad leaf table"}  # csrc's own codes

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile csrc/adamw_step.cu (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.build_library("adamw_step.cu")
    p, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k5_limits.argtypes = [i32]
    lib.k5_limits.restype = ll
    lib.k5_grad_sq.argtypes = [i32, i32, p, p, p, p, p]
    lib.k5_grad_sq.restype = i32
    lib.k5_norm_finish.argtypes = [p, i32, p, p]
    lib.k5_norm_finish.restype = i32
    lib.k5_update.argtypes = [i32, i32, i32, p, p, p, p, p, p, p, p, i32, p, p, p]
    lib.k5_update.restype = i32
    built = tuple(lib.k5_limits(i) for i in range(3))
    if built != (LEAVES_PER_LAUNCH, TILE, NORM_BLOCKS):
        raise RuntimeError(f"adamw_step.cu's limits {built} are not the wrapper's")
    _lib = lib
    return lib


# ------------------------------------------------------------- launch plan


def launch_plan(numels: Sequence[int], keys: Optional[Sequence[Hashable]] = None,
                cap: int = LEAVES_PER_LAUNCH, tile: int = TILE) -> List[Tuple[Hashable, List[int], List[int]]]:
    """The launches over leaves of `numels` elements: [(key, leaf indices,
    block starts)]. Leaves of one key (their dtypes: one kernel
    instantiation) go together, the keys in order of first appearance, cut
    into chunks of at most `cap` leaves in order. In a chunk, leaf i takes
    blocks [starts[i], starts[i + 1]): ceil(numel / tile) of them, so a
    leaf of no element takes none and a chunk of such leaves none at all."""
    keys = [None] * len(numels) if keys is None else list(keys)
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    plan = []
    for k, idx in groups.items():
        for c in range(0, len(idx), cap):
            chunk, starts = idx[c:c + cap], [0]
            for i in chunk:
                starts.append(starts[-1] + -(-int(numels[i]) // tile))
            plan.append((k, chunk, starts))
    return plan


# ----------------------------------------------------------- plain versions


def global_norm_plain(leaves: List[Tensor]) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def bias_corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """1 - b1^step and 1 - b2^step as fp32 values, on the host (no device
    sync)."""
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** float(step)
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** float(step)
    return float(c1), float(c2)


@torch.no_grad()
def adamw_step_plain(params: List[Tensor], grads: List[Tensor], mus: List[Tensor], nus: List[Tensor],
                     decay: Sequence[bool], *, lr: float, b1: float, b2: float, eps: float, weight_decay: float,
                     clip_norm: float, step: int, gnorm: Tensor, ok: Optional[Tensor] = None) -> None:
    """`adamw_step` in plain torch, leaf by leaf and slice by slice."""
    keep = (lambda new, old: new) if ok is None else (lambda new, old: torch.where(ok, new, old))  # noqa: E731
    scale = None
    if clip_norm > 0:
        scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    c1, c2 = bias_corrections(b1, b2, step)
    for g, p, mu, nu, dec in zip(grads, params, mus, nus, decay):
        wd = weight_decay if dec else 0.0
        # slice by slice: the same elementwise math, with the fp32
        # temporaries of one slice live at a time, not of a whole leaf
        for gs, ps, mus_, nus_ in zip(g.reshape(-1).split(_SLICE), p.view(-1).split(_SLICE),
                                      mu.view(-1).split(_SLICE), nu.view(-1).split(_SLICE)):
            if scale is not None:
                gs = gs * scale.to(gs.dtype)
            g32 = gs.float()
            mu_n = b1 * mus_.float() + (1 - b1) * g32
            nu_n = b2 * nus_.float() + (1 - b2) * g32 * g32
            delta = (mu_n / c1) / (torch.sqrt(nu_n / c2) + eps)
            if wd > 0:
                delta = delta + wd * ps.float()
            ps.copy_(keep(ps.float() - lr * delta, ps))
            mus_.copy_(keep(mu_n, mus_))
            nus_.copy_(keep(nu_n, nus_))


# ------------------------------------------------------------------ wrappers


def _device(name: str, leaves) -> torch.device:
    devs = {t.device for t in leaves}
    if len(devs) != 1:
        raise ValueError(f"{name}: leaves on more than one device ({sorted(map(str, devs))})")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_leaves(name: str, leaves) -> None:
    for t in leaves:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported on CUDA (float32, bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: a leaf of shape {tuple(t.shape)} is not contiguous")


def _scalar_on(name: str, what: str, t: Tensor, dtype, dev) -> None:
    if t.dtype != dtype or t.numel() != 1 or t.device != dev:
        raise ValueError(f"{name}: {what} must be one {dtype} on {dev}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _table(chunk: List[int], starts: List[int], *lists):
    """ctypes arrays of one chunk: the pointer lists, the element counts and
    the block starts."""
    ptrs = [(ctypes.c_void_p * len(chunk))(*(lst[i].data_ptr() for i in chunk)) for lst in lists]
    n = (ctypes.c_longlong * len(chunk))(*(lists[0][i].numel() for i in chunk))
    return ptrs, n, (ctypes.c_longlong * len(starts))(*starts)


def global_norm(leaves: List[Tensor]) -> Tensor:
    """The fp32 norm of every leaf together (a device scalar). CUDA: the K5
    norm kernels (one launch a chunk, one to finish); CPU: `global_norm_plain`."""
    dev = _device("global_norm", leaves)
    if dev.type == "cpu":
        return global_norm_plain(leaves)
    _check_leaves("global_norm", leaves)
    plan = launch_plan([g.numel() for g in leaves], [g.dtype for g in leaves])
    partials = torch.empty(len(plan) * NORM_BLOCKS, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c, (dtype, chunk, starts) in enumerate(plan):
            (g,), n, bs = _table(chunk, starts, leaves)
            rc = lib.k5_grad_sq(_DTYPES[dtype], len(chunk), g, n, bs,
                                partials[c * NORM_BLOCKS:].data_ptr(), stream)
            nvcc.raise_on(rc, "global_norm", _RC)
        nvcc.raise_on(lib.k5_norm_finish(partials.data_ptr(), partials.numel(), out.data_ptr(), stream),
                      "global_norm", _RC)
    global_norm.launches += len(plan) + 1
    return out


def adamw_step(params: List[Tensor], grads: List[Tensor], mus: List[Tensor], nus: List[Tensor],
               decay: Sequence[bool], *, lr: float, b1: float, b2: float, eps: float, weight_decay: float,
               clip_norm: float, step: int, gnorm: Tensor, ok: Optional[Tensor] = None) -> None:
    """One AdamW step of every leaf, in place: params, first and second
    moments updated from `grads` (leaf i of each list together), weight
    decay on the leaves whose `decay` is true, the gradients scaled by
    min(clip_norm / max(gnorm, 1e-9), 1) where clip_norm > 0, bias
    corrections for `step`. `ok` (a device bool, or None) makes the step
    conditional: where it is false nothing is written. CUDA: the K5 update
    kernel (one launch a chunk); CPU: `adamw_step_plain`."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, clip_norm=clip_norm, step=step,
              gnorm=gnorm, ok=ok)
    name = "adamw_step"
    if not (len(params) == len(grads) == len(mus) == len(nus) == len(decay)):
        raise ValueError(f"{name}: {len(params)} params, {len(grads)} grads, {len(mus)} / {len(nus)} moments, "
                         f"{len(decay)} decay flags")
    dev = _device(name, [*params, *grads, *mus, *nus])
    if dev.type == "cpu":
        return adamw_step_plain(params, grads, mus, nus, decay, **kw)
    for lst in (params, grads, mus, nus):
        _check_leaves(name, lst)
    for p, g, m, v in zip(params, grads, mus, nus):
        if not p.numel() == g.numel() == m.numel() == v.numel():
            raise ValueError(f"{name}: a leaf of {p.numel()} elements has a gradient of {g.numel()} and "
                             f"moments of {m.numel()} / {v.numel()}")
        if g.dtype != p.dtype or v.dtype != m.dtype:
            raise TypeError(f"{name}: param {p.dtype} with gradient {g.dtype}, moments {m.dtype} / {v.dtype} "
                            "(the kernel takes the gradient in the param's dtype, both moments in one)")
    _scalar_on(name, "gnorm", gnorm, torch.float32, dev)
    if ok is not None:
        _scalar_on(name, "ok", ok, torch.bool, dev)
    c1, c2 = bias_corrections(b1, b2, step)
    # as PyTorch's CUDA ops see them: each Python scalar rounded to fp32 (the
    # ctypes conversion), a division by c becomes a product with its fp32
    # reciprocal (1.0 / c rounded once more to fp32 is that reciprocal)
    scalars = (ctypes.c_float * 10)(lr, b1, 1 - b1, b2, 1 - b2, 1.0 / c1, 1.0 / c2, eps, weight_decay, clip_norm)
    flags = [bool(d) and weight_decay > 0 for d in decay]
    plan = launch_plan([p.numel() for p in params], [(p.dtype, m.dtype) for p, m in zip(params, mus)])
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for dtypes, chunk, starts in plan:
            if starts[-1] == 0:  # no element in the chunk
                continue
            (p, g, m, v), n, bs = _table(chunk, starts, params, grads, mus, nus)
            rc = lib.k5_update(_DTYPES[dtypes[0]], _DTYPES[dtypes[1]], len(chunk), p, g, m, v, n, bs,
                               (ctypes.c_ubyte * len(chunk))(*(flags[i] for i in chunk)), scalars,
                               int(clip_norm > 0), gnorm.data_ptr(), None if ok is None else ok.data_ptr(),
                               stream)
            nvcc.raise_on(rc, name, _RC)
            adamw_step.launches += 1
    adamw_step.elements += sum(p.numel() for p in params)


global_norm.launches = 0
adamw_step.launches = 0
adamw_step.elements = 0


def reset_launch_counts() -> None:
    global_norm.launches = 0
    adamw_step.launches = 0
    adamw_step.elements = 0


__all__ = [
    "LEAVES_PER_LAUNCH",
    "NORM_BLOCKS",
    "TILE",
    "adamw_step",
    "adamw_step_plain",
    "bias_corrections",
    "build",
    "global_norm",
    "global_norm_plain",
    "launch_plan",
    "reset_launch_counts",
]
