"""Self-contained byte-level BPE tokenizer (a copy of src/repro/data/tokenizer.py:
the same merges, ids and JSON file; DESIGN.md §Data).

No external tokenizer dependency: the base alphabet is the 256 bytes, so
any UTF-8 text round-trips losslessly (encode -> decode is the identity on
strings; unknown symbols can't exist). Merges are learned on a corpus
sample with whitespace pre-chunking (merges never cross a \\S+/\\s+ chunk
boundary — the standard trick that keeps training near-linear and encoding
cacheable per chunk).

Token-id layout (stable across save/load):

    0..255                  raw bytes
    256..256+n_merges-1     merged pairs, in rank order
    vocab_size-1            EOS (doubles as the pad token; padded label
                            positions are masked with -1, so the pad id
                            only ever appears on the input side)

The serialized form is a single JSON file (merges as id pairs + the
declared vocab size), written next to the run's checkpoints so a training
run is reproducible from its artifacts alone.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

_CHUNK_RE = re.compile(r"\S+|\s+")
_N_SPECIAL = 1  # EOS


def _chunk(text: str) -> List[str]:
    """Split into alternating word / whitespace runs; concat == text."""
    return _CHUNK_RE.findall(text)


class ByteBPETokenizer:
    """Byte-level BPE with a fixed vocab budget.

    merges: ordered list of (left_id, right_id) pairs; merge i produces
    token id 256 + i. `vocab_size` includes the byte alphabet, the merges,
    and the EOS special.
    """

    def __init__(self, merges: Sequence[Tuple[int, int]], vocab_size: int):
        merges = [tuple(m) for m in merges]
        assert vocab_size >= 256 + len(merges) + _N_SPECIAL, (
            vocab_size,
            len(merges),
        )
        self.merges: List[Tuple[int, int]] = merges
        self.vocab_size = int(vocab_size)
        self.eos_id = self.vocab_size - 1
        self._ranks: Dict[Tuple[int, int], int] = {
            pair: i for i, pair in enumerate(merges)
        }
        self._cache: Dict[str, Tuple[int, ...]] = {}

    # ------------------------------------------------------------ encode

    def _bpe(self, chunk: str) -> Tuple[int, ...]:
        cached = self._cache.get(chunk)
        if cached is not None:
            return cached
        ids = list(chunk.encode("utf-8"))
        while len(ids) > 1:
            best_rank, best_i = None, -1
            for i in range(len(ids) - 1):
                r = self._ranks.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            new_id = 256 + best_rank
            # merge every occurrence of this exact pair in one pass
            out, i = [], 0
            while i < len(ids):
                if (
                    i < len(ids) - 1
                    and ids[i] == self.merges[best_rank][0]
                    and ids[i + 1] == self.merges[best_rank][1]
                ):
                    out.append(new_id)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        result = tuple(ids)
        if len(self._cache) < 65536:
            self._cache[chunk] = result
        return result

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for chunk in _chunk(text):
            out.extend(self._bpe(chunk))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        # expand merges recursively back to bytes
        expand = self._expand_table()
        data = bytearray()
        for t in ids:
            t = int(t)
            if t == self.eos_id or t >= 256 + len(self.merges):
                continue  # specials / unused budget carry no bytes
            data.extend(expand[t])
        return data.decode("utf-8", errors="replace")

    def _expand_table(self) -> List[bytes]:
        table: List[bytes] = [bytes([b]) for b in range(256)]
        for left, right in self.merges:
            table.append(table[left] + table[right])
        return table

    # ------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "format": "repro.byte_bpe.v1",
                    "vocab_size": self.vocab_size,
                    "merges": [list(m) for m in self.merges],
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path) as f:
            obj = json.load(f)
        assert obj.get("format") == "repro.byte_bpe.v1", obj.get("format")
        return cls(
            merges=[tuple(m) for m in obj["merges"]],
            vocab_size=obj["vocab_size"],
        )

    # ---------------------------------------------------------- training

    @classmethod
    def train(
        cls, texts: Iterable[str], vocab_size: int, max_sample_chunks: int = 200_000
    ) -> "ByteBPETokenizer":
        """Learn merges by greedy pair-frequency BPE on chunk counts.

        The merge budget is vocab_size - 256 - 1 (EOS); training stops early
        if no pair repeats (tiny corpora), leaving unused ids between the
        last merge and EOS — harmless, EOS stays pinned at vocab_size - 1.
        """
        assert vocab_size > 256 + _N_SPECIAL, "vocab must exceed byte alphabet"
        counts: Dict[Tuple[int, ...], int] = {}
        n_chunks = 0
        for text in texts:
            for chunk in _chunk(text):
                key = tuple(chunk.encode("utf-8"))
                if len(key) > 1:
                    counts[key] = counts.get(key, 0) + 1
                n_chunks += 1
            if n_chunks >= max_sample_chunks:
                break

        words = {k: list(k) for k in counts}
        merges: List[Tuple[int, int]] = []
        budget = vocab_size - 256 - _N_SPECIAL
        while len(merges) < budget:
            pair_counts: Dict[Tuple[int, int], int] = {}
            for key, ids in words.items():
                c = counts[key]
                for a, b in zip(ids, ids[1:]):
                    pair_counts[(a, b)] = pair_counts.get((a, b), 0) + c
            if not pair_counts:
                break
            # deterministic: break count ties by smallest pair ids
            (left, right), best = min(
                pair_counts.items(), key=lambda kv: (-kv[1], kv[0])
            )
            if best < 2:
                break
            new_id = 256 + len(merges)
            merges.append((left, right))
            for key, ids in words.items():
                out, i = [], 0
                while i < len(ids):
                    if i < len(ids) - 1 and ids[i] == left and ids[i + 1] == right:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(ids[i])
                        i += 1
                words[key] = out
        return cls(merges=merges, vocab_size=vocab_size)


# ----------------------------------------------------------- corpus helpers


def parse_doc_line(path: str, line: str) -> Optional[str]:
    """One shard line -> document text (None for blanks). The single
    definition of the corpus line format — the tokenizer trainer and the
    loader must agree on what a document is."""
    line = line.rstrip("\n")
    if not line:
        return None
    if path.endswith(".jsonl"):
        return json.loads(line)["text"]
    return line


def iter_corpus_texts(paths: Sequence[str]) -> Iterator[str]:
    """Yield document texts from .jsonl ({'text': ...} per line) / .txt
    (one document per line) shards, in path order."""
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                text = parse_doc_line(path, line)
                if text is not None:
                    yield text


def train_tokenizer_from_files(
    paths: Sequence[str], vocab_size: int, max_sample_chunks: int = 200_000
) -> ByteBPETokenizer:
    return ByteBPETokenizer.train(
        iter_corpus_texts(paths), vocab_size, max_sample_chunks=max_sample_chunks
    )
