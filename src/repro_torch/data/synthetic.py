"""Synthetic language-modelling data with learnable structure (a numpy copy
of src/repro/data/synthetic.py's generator).

An order-2 mixture over the vocab: Zipf-distributed unigrams plus a fixed
random successor table ("grammar") followed with probability `structure`.
Skewed unigrams put routing-collapse pressure on the experts; the grammar
gives the model something to learn. Every batch is a pure function of
(vocab, seq_len, seed, split, batch index), drawn with numpy exactly as the
reference draws it, so both packages train on bit-identical tokens; the
port hands them out as int64 tensors on the model's device. Batches of the
vlm and encdec families also carry the reference's seeded modality stubs
(`frontend_stubs`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    """Order-2 mixture: zipf unigrams + cyclic grammar, split train/test."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    structure: float = 0.75  # fraction of steps that follow the grammar

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        probs = 1.0 / np.arange(1, v + 1) ** self.zipf_a
        self._probs = probs / probs.sum()
        self._succ = rng.permutation(v).astype(np.int64)  # tok -> next tok

    def sample_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        out[0] = rng.choice(self.vocab_size, p=self._probs)
        structured = rng.random(n) < self.structure
        iid = rng.choice(self.vocab_size, size=n, p=self._probs)
        for t in range(1, n):
            out[t] = self._succ[out[t - 1]] if structured[t] else iid[t]
        return out

    def batch(self, batch_size: int, index: int, split: str = "train", device="cpu"):
        """Batch `index` of the split: {'tokens', 'labels'} (B, seq_len) int64."""
        base = self.seed * 1_000_003 + (500_000 if split == "test" else 0)
        rng = np.random.default_rng(base + index)
        toks = np.stack([self.sample_tokens(rng, self.seq_len + 1) for _ in range(batch_size)])
        toks = torch.from_numpy(toks).to(device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, batch_size: int, n_batches: int, split: str = "train",
                device="cpu") -> Iterator[Dict[str, torch.Tensor]]:
        """Deterministic batch stream; 'test' uses a disjoint seed stream."""
        for b in range(n_batches):
            yield self.batch(batch_size, b, split, device)


def frontend_stubs(cfg: ModelConfig, batch_size: int, seed: int = 0, device="cpu"):
    """The modality stubs a batch of `cfg`'s family carries, as the
    reference draws them: vlm 'patches' (B, frontend_tokens, frontend_dim),
    encdec 'frames' (B, enc_seq_len, frontend_dim), standard normals from
    numpy's default_rng(seed) in fp32 (the same for every batch); {} for
    the token families."""
    shapes = {
        "vlm": ("patches", (batch_size, cfg.frontend_tokens, cfg.frontend_dim)),
        "encdec": ("frames", (batch_size, cfg.enc_seq_len, cfg.frontend_dim)),
    }
    if cfg.family not in shapes:
        return {}
    key, shape = shapes[cfg.family]
    stub = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return {key: torch.from_numpy(stub).to(device)}


def make_batches(cfg: ModelConfig, batch_size: int, seq_len: int, n_batches: int,
                 seed: int = 0, split: str = "train", device="cpu"):
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len, seed=seed)
    for batch in ds.batches(batch_size, n_batches, split, device):
        batch.update(frontend_stubs(cfg, batch_size, seed, device))
        yield batch


class SyntheticBatchStream:
    """`make_batches` behind a cursor: the whole state is the step index,
    so `load_state_dict({'step': n})` resumes in O(1)."""

    def __init__(self, cfg: ModelConfig, batch_size: int, seq_len: int,
                 n_batches: int, seed: int = 0, split: str = "train", device="cpu"):
        self.cfg = cfg
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.seed = seed
        self.split = split
        self.device = device
        self._ds = SyntheticLMDataset(cfg.vocab_size, seq_len, seed=seed)
        self._step = 0

    def __iter__(self):
        while self._step < self.n_batches:
            batch = self._ds.batch(self.batch_size, self._step, self.split, self.device)
            batch.update(frontend_stubs(self.cfg, self.batch_size, self.seed, self.device))
            self._step += 1
            yield batch

    def state_dict(self) -> Dict:
        return {"step": self._step}

    def load_state_dict(self, state: Dict) -> None:
        self._step = int(state["step"])
