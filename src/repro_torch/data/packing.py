"""Document packing into fixed-length training sequences (a copy of
src/repro/data/packing.py; DESIGN.md §Data).

Three pack modes, all emitting (seq_len+1)-token windows from which the
batch builder derives `tokens = w[:-1]`, `labels = w[1:]` (with invalid
label positions set to -1, which `Model.loss_fn` masks out):

* ``pack`` — documents are concatenated into one stream with an EOS after
  every document; windows tile the stream with stride seq_len (1-token
  overlap), so **every stream token is a label exactly once** and no token
  is dropped. Attention is plain causal across document boundaries (the
  standard GPT recipe).
* ``pack_nocross`` — same stream, but each window carries per-position
  ``segments`` (document index within the stream); labels that would
  predict the first token of the *next* document are masked, and the model
  masks attention to ``seg_q == seg_k`` when the batch carries
  ``segments`` (see `models.common.attention`), so no information crosses
  a document boundary.
* ``pad`` — one document per sequence, truncated at seq_len+1, padded with
  EOS; labels past the document's EOS are masked. (Truncation loses the
  tail of over-long documents — this mode trades tokens for clean
  per-document sequences.)

The packer is a resumable stream stage: `state_dict()` captures the
pending stream tail and the running segment counter, so the loader's
checkpoint cursor (data/loader.py) restores mid-pack bit-exactly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

PACK_MODES = ("pack", "pack_nocross", "pad")


class SequencePacker:
    """Feeds documents in, yields fixed-length window examples out.

    An example is a dict of np arrays:
        window   (seq_len+1,) int32 token ids
        valid    (seq_len,)   bool: label positions that count toward loss
        segments (seq_len+1,) int32 — only in 'pack_nocross' mode
    """

    def __init__(self, seq_len: int, eos_id: int, mode: str = "pack"):
        assert mode in PACK_MODES, mode
        assert seq_len >= 2
        self.seq_len = seq_len
        self.eos_id = eos_id
        self.mode = mode
        self._buf: List[int] = []
        self._seg: List[int] = []
        self._next_seg = 0

    # ------------------------------------------------------------ feeding

    def add_document(self, ids: Sequence[int]) -> List[Dict[str, np.ndarray]]:
        """Append one document (EOS added here); returns completed windows."""
        ids = list(int(t) for t in ids)
        if not ids:
            return []
        if self.mode == "pad":
            return [self._pad_example(ids)]
        seg = self._next_seg
        self._next_seg += 1
        self._buf.extend(ids + [self.eos_id])
        self._seg.extend([seg] * (len(ids) + 1))
        return self._drain()

    def flush(self) -> List[Dict[str, np.ndarray]]:
        """Emit the final partial window (EOS-padded, pad labels masked).

        A buffer holding only the 1-token overlap tail (or less) carries no
        unconsumed labels and is dropped."""
        out = self._drain()
        if len(self._buf) > 1:
            n = len(self._buf)
            window = self._buf + [self.eos_id] * (self.seq_len + 1 - n)
            seg = self._seg + [-1] * (self.seq_len + 1 - n)
            valid = np.zeros(self.seq_len, bool)
            valid[: n - 1] = True
            out.append(self._example(window, seg, valid))
        self._buf, self._seg = [], []
        return out

    # ----------------------------------------------------------- plumbing

    def _drain(self) -> List[Dict[str, np.ndarray]]:
        out = []
        L = self.seq_len
        while len(self._buf) >= L + 1:
            window, seg = self._buf[: L + 1], self._seg[: L + 1]
            out.append(self._example(window, seg, np.ones(L, bool)))
            # stride L: the window's last token re-enters as the next
            # window's first input, so it is a label exactly once
            self._buf = self._buf[L:]
            self._seg = self._seg[L:]
        return out

    def _example(self, window, seg, valid) -> Dict[str, np.ndarray]:
        window = np.asarray(window, np.int32)
        ex = {"window": window, "valid": np.asarray(valid, bool)}
        if self.mode == "pack_nocross":
            seg = np.asarray(seg, np.int32)
            # mask labels that cross a segment boundary (predicting the
            # first token of the next document from the previous one)
            ex["valid"] = ex["valid"] & (seg[1:] == seg[:-1])
            ex["segments"] = seg
        return ex

    def _pad_example(self, ids: List[int]) -> Dict[str, np.ndarray]:
        L = self.seq_len
        stream = ids + [self.eos_id]
        n = min(len(stream), L + 1)
        window = stream[:n] + [self.eos_id] * (L + 1 - n)
        valid = np.zeros(L, bool)
        valid[: n - 1] = True
        return {"window": np.asarray(window, np.int32), "valid": valid}

    # -------------------------------------------------------------- state

    def state_dict(self) -> Dict:
        return {
            "buf": list(self._buf),
            "seg": list(self._seg),
            "next_seg": self._next_seg,
        }

    def load_state_dict(self, state: Dict) -> None:
        self._buf = list(state["buf"])
        self._seg = list(state["seg"])
        self._next_seg = int(state["next_seg"])


def examples_to_batch(
    examples: Sequence[Dict[str, np.ndarray]]
) -> Dict[str, np.ndarray]:
    """Stack packer examples into the model's batch dict.

    labels are the shifted window with invalid positions set to -1
    (masked by loss_fn); 'segments' rides along iff the packer emitted it,
    renumbered per row from 0 (values are row-local document indices)."""
    windows = np.stack([e["window"] for e in examples])
    valid = np.stack([e["valid"] for e in examples])
    batch = {
        "tokens": windows[:, :-1].astype(np.int32),
        "labels": np.where(valid, windows[:, 1:], -1).astype(np.int32),
    }
    if "segments" in examples[0]:
        seg = np.stack([e["segments"] for e in examples])[:, :-1]
        batch["segments"] = (seg - seg[:, :1]).astype(np.int32)
    return batch
