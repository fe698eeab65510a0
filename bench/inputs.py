"""The inputs the benchmark hands both sides: seeded weights and a pool of
synthetic token batches. Nothing here imports the program.

Weights: one normal draw of every parameter at once, on the device, from a
torch.Generator seeded with the run's seed, cut into the leaves of the
model's tree (views of the one buffer) and scaled, or set, as the model
initialises them. Which leaves, and how, is the configuration's: its plain
reference lists them (`leaf_specs(cfg)` in bench/reference/<reference>.py).
The same seed gives the same numbers on the same device, so the reference
regenerates them rather than keeping a copy.

Tokens: a copy of the port's synthetic language-model generator (Zipf
unigrams plus a random successor grammar followed with probability
`structure`); every batch is a pure function of (seed, batch index).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor
Spec = Tuple[tuple, tuple, Union[float, Tensor]]


def make_params(specs: Sequence[Spec], seed: int, device) -> Dict:
    """The seeded fp32 parameter tree of `specs` (every leaf a view of one
    buffer): (keys from the root, shape, init) per leaf, as a reference's
    `leaf_specs` lists them. An init is a float, the scale of the leaf's
    normal draw, or a tensor, a fixed value broadcast over the leaf (a norm's
    ones, a zero bias, a vector such as a decay's). The draw covers every
    leaf in spec order, fixed ones too, so a leaf's offset, and so its bits,
    depend only on the leaves listed before it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in specs), generator=gen, device=device)
    tree: dict = {}
    at = 0
    with torch.no_grad():
        for keys, shape, init in specs:
            leaf = flat[at:at + math.prod(shape)].view(shape)
            at += leaf.numel()
            if isinstance(init, Tensor):
                leaf.copy_(init.to(device).expand(shape))
            else:
                leaf.mul_(init)
            node = tree
            for key, nxt in zip(keys[:-1], keys[1:]):
                if isinstance(key, int):
                    if key == len(node):
                        node.append({})
                    node = node[key]
                else:
                    node = node.setdefault(key, [] if isinstance(nxt, int) else {})
            node[keys[-1]] = leaf
    return tree


class SyntheticLM:
    """Order-2 mixture: Zipf unigrams plus a cyclic successor grammar."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int, zipf_a: float, structure: float):
        self.vocab_size, self.seq_len, self.seed, self.structure = vocab_size, seq_len, seed, structure
        rng = np.random.default_rng(seed)
        probs = 1.0 / np.arange(1, vocab_size + 1) ** zipf_a
        self._probs = probs / probs.sum()
        self._succ = rng.permutation(vocab_size).astype(np.int64)

    def _row(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        out[0] = rng.choice(self.vocab_size, p=self._probs)
        structured = rng.random(n) < self.structure
        iid = rng.choice(self.vocab_size, size=n, p=self._probs)
        for t in range(1, n):
            out[t] = self._succ[out[t - 1]] if structured[t] else iid[t]
        return out

    def batch(self, batch_size: int, index: int) -> np.ndarray:
        """Batch `index`: (B, seq_len + 1) tokens; inputs [:, :-1], labels [:, 1:]."""
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        return np.stack([self._row(rng, self.seq_len + 1) for _ in range(batch_size)])


def batch_pool(vocab_size: int, mix: dict, seed: int, device) -> Tensor:
    """(pool_batches, B, S + 1) int64 tokens on the device."""
    ds = SyntheticLM(vocab_size, mix["seq_len"], seed, mix["zipf_a"], mix["structure"])
    pool = np.stack([ds.batch(mix["batch"], i) for i in range(mix["pool_batches"])])
    return torch.from_numpy(pool).to(device)


def batch(pool: Tensor, i: int) -> Dict[str, Tensor]:
    """Batch i of the pool (cycling), as the train step takes it."""
    rows = pool[i % pool.shape[0]]
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
