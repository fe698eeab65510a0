"""K5's host side on the CPU (kernels/adamw_step.py): the leaf table that
the update and norm launches take covers every element of every leaf once,
and CPU leaves take the plain path. The kernels themselves run in
tests/test_torch_cuda.py."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's cells live beside src/
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402
from bench.reference import granite_moe_hybrid  # noqa: E402
from repro_torch.kernels import adamw_step  # noqa: E402
from repro_torch.kernels.adamw_step import LEAVES_PER_LAUNCH, TILE, launch_plan  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def _granite_numels(sliced: bool):
    """The element counts of the granite cell's 168 leaves, or of the 177
    slices of _SLICE elements the plain update cuts them into."""
    cell = harness.resolve("train-granite-h-small-bip-s2048")
    numels = [math.prod(shape) for _, shape, _ in granite_moe_hybrid.leaf_specs(cell.config["config"])]
    if sliced:
        numels = [min(adamw_step._SLICE, n - s) for n in numels for s in range(0, n, adamw_step._SLICE)]
    return numels


def block_tile(starts, b):
    """(leaf position in the chunk, tile of the leaf) that block b of a
    chunk's launch updates, by csrc/adamw_step.cu's `find_leaf`: the last j
    with starts[j] <= b."""
    lo, hi = 0, len(starts) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if starts[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo, b - starts[lo]


def _check_plan(numels, keys=None, exhaustive=True):
    plan = launch_plan(numels, keys)
    seen = []
    for key, chunk, starts in plan:
        assert 1 <= len(chunk) <= LEAVES_PER_LAUNCH and len(starts) == len(chunk) + 1 and starts[0] == 0
        assert keys is None or all(keys[i] == key for i in chunk)
        seen += chunk
        bs = np.asarray(starts)
        blocks = np.arange(starts[-1])
        # every block of the launch: its leaf and tile, as the kernel finds them
        leaf = np.searchsorted(bs, blocks, side="right") - 1
        tile = blocks - bs[leaf]
        probe = blocks if exhaustive else np.unique(np.concatenate([bs[:-1], bs[1:] - 1, bs[1:]]))
        for b in probe[(probe >= 0) & (probe < starts[-1])]:
            assert block_tile(starts, int(b)) == (leaf[b], tile[b])
        assert (np.diff(leaf) >= 0).all()  # so leaf j's blocks are one run
        for j, i in enumerate(chunk):
            n = int(numels[i])
            tiles = tile[starts[j]:starts[j + 1]]
            assert (leaf[starts[j]:starts[j + 1]] == j).all()
            # tiles 0..T-1 once each, T * TILE >= n > (T - 1) * TILE: the
            # ranges [t * TILE, min(n, (t + 1) * TILE)) cover [0, n) once
            assert np.array_equal(tiles, np.arange(len(tiles)))
            assert len(tiles) * TILE >= n > (len(tiles) - 1) * TILE
            if exhaustive and n:
                covered = np.zeros(n, dtype=np.int64)
                for t in tiles:
                    covered[t * TILE:min(n, (t + 1) * TILE)] += 1
                assert (covered == 1).all()
    assert sorted(seen) == list(range(len(numels)))  # every leaf in exactly one chunk
    if keys is not None:  # within a key, the leaves keep their order
        for key in set(keys):
            assert [i for k, c, _ in plan if k == key for i in c] == [i for i, k in enumerate(keys) if k == key]
    return plan


@pytest.mark.parametrize("case", ["ragged", "empty", "chunks", "keys", "granite_leaves", "granite_slices"])
def test_launch_plan_covers_every_element_once(case):
    """Ragged tails, leaves and whole chunks of no element, more leaves than
    one launch takes, two dtype groups interleaved, and the granite cell's
    168 leaves (2.06 B parameters) and 177 slices."""
    rng = np.random.default_rng(0)
    if case == "ragged":
        plan = _check_plan([1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5, 7])
        assert plan[0][2] == [0, 1, 2, 3, 5, 9, 10]
    elif case == "empty":
        plan = _check_plan([0] * LEAVES_PER_LAUNCH + [0, 5, 0, TILE + 3, 0])
        assert plan[0][2][-1] == 0 and plan[1][2] == [0, 0, 1, 1, 3, 3]  # a chunk of no block
    elif case == "chunks":
        numels = rng.integers(0, 3 * TILE, 2 * LEAVES_PER_LAUNCH + 13).tolist()
        assert [len(c) for _, c, _ in _check_plan(numels)] == [LEAVES_PER_LAUNCH, LEAVES_PER_LAUNCH, 13]
    elif case == "keys":
        numels = rng.integers(1, 2 * TILE, 150).tolist()
        keys = [("f32", "f32") if i % 3 else ("bf16", "bf16") for i in range(150)]
        plan = _check_plan(numels, keys)
        assert [k for k, _, _ in plan] == [("bf16", "bf16"), ("f32", "f32"), ("f32", "f32")]
    else:
        numels = _granite_numels(sliced=case == "granite_slices")
        assert (len(numels), sum(numels)) == ((177 if case == "granite_slices" else 168), 2_055_031_424)
        plan = _check_plan(numels, exhaustive=False)
        assert len(plan) == -(-len(numels) // LEAVES_PER_LAUNCH)
        assert sum(starts[-1] for _, _, starts in plan) == sum(-(-n // TILE) for n in numels)


def test_cpu_leaves_take_the_plain_path():
    """On CPU leaves `adamw_update` runs the plain version (no kernel is
    built or counted): its state after two steps, one of them clipped, is
    bit-equal to `adamw_step_plain` called leaf by leaf; the norm is
    `global_norm_plain`'s. Leaves on two devices are refused."""
    gen = torch.Generator().manual_seed(0)
    base = {"a": torch.randn(33, 7, generator=gen), "b": torch.randn(5, generator=gen)}
    cfg = adamw.AdamWConfig(clip_norm=1.0)
    adamw_step.reset_launch_counts()
    params = adamw.tree_map(torch.clone, base)
    opt = adamw.adamw_init(params, cfg)
    mine = adamw.tree_map(torch.clone, base)
    mu = [torch.zeros_like(t) for t in adamw.tree_leaves(mine)]
    nu = [torch.zeros_like(t) for t in adamw.tree_leaves(mine)]
    for step, g_scale in ((1, 0.01), (2, 10.0)):
        grads = [g_scale * torch.randn(t.shape, generator=gen) for t in adamw.tree_leaves(base)]
        _, _, info = adamw.adamw_update(list(grads), opt, params, 1e-3, cfg, decay={"a": True, "b": False})
        gnorm = adamw_step.global_norm_plain(grads)
        assert torch.equal(info["grad_norm"], gnorm)
        adamw_step.adamw_step_plain(adamw.tree_leaves(mine), grads, mu, nu, [True, False], lr=1e-3, b1=cfg.b1,
                                    b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay,
                                    clip_norm=cfg.clip_norm, step=step, gnorm=gnorm)
    got = adamw.tree_leaves([params, opt["mu"], opt["nu"]])
    assert all(torch.equal(a, b) for a, b in zip(got, adamw.tree_leaves(mine) + mu + nu))
    counts = adamw_step.global_norm.launches, adamw_step.adamw_step.launches, adamw_step.adamw_step.elements
    assert counts == (0, 0, 0)
    meta = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="more than one device"):
        adamw_step.global_norm([torch.zeros(3), meta])
    with pytest.raises(ValueError, match="more than one device"):
        adamw_step.adamw_step([meta], [torch.zeros(3)], [meta], [meta], [False], lr=1e-3, b1=0.9, b2=0.95,
                              eps=1e-8, weight_decay=0.1, clip_norm=1.0, step=1, gnorm=torch.ones(()))
