"""Deterministic, resumable, rank-sharded text-shard loader (a copy of
src/repro/data/loader.py; DESIGN.md §Data). Rank and world size are given
by the caller (0 and 1 on one GPU); batches are numpy arrays.

`ShardedTextLoader` reads .jsonl / .txt shards and yields model-ready
batches (tokens / labels [/ segments]) through tokenize -> shuffle-buffer
-> pack stages. Two properties the training harness depends on:

* **Determinism + rank sharding** — documents are numbered in (epoch,
  file, line) order; rank r of world W owns documents with index % W == r.
  Every rank scans the same shard list (document striding, not file
  striding, so any W partitions any corpus evenly) and the per-rank stream
  is a pure function of (shards, seed, rank, world_size).
* **Checkpointable cursor** — `state_dict()` is an *offset-replay* cursor:
  it records the stream position (epoch, file index, byte offset, document
  counter), the RNG and packer state as of the start of the current
  shuffle block, and two counters (documents drained from the block,
  packed windows already consumed into emitted batches). It never
  serializes buffered document *contents*: `load_state_dict()` seeks to
  the block anchor and re-reads at most one block, re-deriving the buffer
  membership from the replayed RNG. The cursor size is therefore O(1) in
  `shuffle_buffer` — O(batch_size · seq_len) for the packer tail and the
  sub-batch pending windows — so it stays sidecar-sized at production
  buffer sizes.

Shuffling is *block* shuffling: read `shuffle_buffer` documents, permute
them with the stream RNG, drain them to the packer, repeat. Within-block
order is uniform; mixing across blocks comes from epoch reseeding. The
whole state is JSON-serializable (ints, lists, the PCG64 state dict) and
rides in a sidecar file next to the TrainState npz (checkpoint/store.py).
"""
from __future__ import annotations

import glob as _glob
import os
import time
from typing import Dict, Iterator, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.data.packing import SequencePacker, examples_to_batch
from repro_torch.data.tokenizer import ByteBPETokenizer, parse_doc_line


@runtime_checkable
class BatchStream(Protocol):
    """An iterable of batch dicts with a checkpointable cursor.

    `state_dict()` must describe exactly the batches already yielded, so
    that a fresh stream + `load_state_dict()` continues with the next
    batch bit-exactly (train_loop checkpoints it alongside TrainState)."""

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]: ...

    def state_dict(self) -> Dict: ...

    def load_state_dict(self, state: Dict) -> None: ...


def resolve_shards(data: str) -> List[str]:
    """Expand a directory / glob / single file into a sorted shard list."""
    if os.path.isdir(data):
        paths = [
            os.path.join(data, f)
            for f in os.listdir(data)
            if f.endswith((".jsonl", ".txt"))
        ]
    elif any(ch in data for ch in "*?["):
        paths = _glob.glob(data)
    else:
        paths = [data]
    paths = sorted(paths)
    if not paths:
        raise FileNotFoundError(f"no .jsonl/.txt shards under {data!r}")
    return paths


class ShardedTextLoader:
    """BatchStream over text shards: tokenize -> shuffle -> pack -> batch.

    epochs=None loops the corpus forever (reshuffling each epoch with a
    deterministic per-epoch seed); a finite epoch count flushes the packer
    at the end and drops the final sub-batch-size remainder (static batch
    shapes keep the jit cache to one entry).

    I/O robustness (DESIGN.md §Robustness): transient shard open/read
    errors are retried with exponential backoff — up to `io_retries`
    CONSECUTIVE failures (any successful read resets the streak) before
    the error propagates. A failed handle is reopened and re-seeked to
    `_byte_offset`, which always points at the start of the next unread
    line, so retries never skip or duplicate a document. Undecodable
    .jsonl lines are skipped (their document index is still consumed, so
    every rank skips the same line and rank sharding stays aligned). Both
    pathologies are counted and the counters ride in `state_dict()`.
    `open_fn` is injectable for fault-injection tests (robustness.faults).
    """

    def __init__(
        self,
        shards: Sequence[str],
        tokenizer: ByteBPETokenizer,
        *,
        batch_size: int,
        seq_len: int,
        pack_mode: str = "pack",
        rank: int = 0,
        world_size: int = 1,
        shuffle_buffer: int = 64,
        seed: int = 0,
        epochs: Optional[int] = None,
        io_retries: int = 3,
        io_backoff: float = 0.05,
        open_fn=None,
    ):
        assert 0 <= rank < world_size
        self.shards = [str(p) for p in shards]
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.pack_mode = pack_mode
        self.rank = rank
        self.world_size = world_size
        self.shuffle_buffer = max(1, shuffle_buffer)
        self.seed = seed
        self.epochs = epochs
        self.io_retries = max(0, io_retries)
        self.io_backoff = io_backoff
        self._open_fn = open_fn if open_fn is not None else open

        self._n_io_retries = 0     # transient open/read failures retried
        self._n_skipped_lines = 0  # undecodable .jsonl lines dropped
        self._io_streak = 0        # consecutive failures (resets on success)
        self._epoch = 0
        self._file_idx = 0
        self._byte_offset = 0
        self._doc_count = 0  # global (all-rank) doc counter within the epoch
        self._rng = np.random.default_rng(self._epoch_seed(0))
        self._packer = SequencePacker(seq_len, tokenizer.eos_id, pack_mode)
        self._pending: List[Dict[str, np.ndarray]] = []  # packed windows
        self._batches_emitted = 0
        self._exhausted = False
        self._fh = None
        # block-shuffle replay state: `_block` holds the not-yet-drained
        # remainder of the current permuted block (reversed: pop() = next);
        # `_anchor` snapshots everything needed to replay the block from
        # the stream, so the cursor never stores document contents
        self._block: List[List[int]] = []
        self._drained = 0            # docs of the current block already packed
        self._windows_consumed = 0   # windows emitted into batches since anchor
        self._flushed_since_anchor = False
        self._anchor = self._make_anchor()

    # ----------------------------------------------------------- reading

    def _epoch_seed(self, epoch: int) -> np.random.SeedSequence:
        return np.random.SeedSequence([self.seed, epoch])

    def _open(self):
        if self._fh is None and self._file_idx < len(self.shards):
            fh = self._open_fn(self.shards[self._file_idx], "r", encoding="utf-8")
            fh.seek(self._byte_offset)
            self._fh = fh
            self._io_streak = 0  # a successful open is progress too
        return self._fh

    def _io_retry_or_raise(self, err: OSError) -> None:
        """Transient open/read failure: drop the handle, back off, let the
        caller re-attempt (the reopen seeks to `_byte_offset`, the start of
        the next unread line). Raises after `io_retries` CONSECUTIVE
        failures — any successful read resets the streak."""
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        self._io_streak += 1
        if self._io_streak > self.io_retries:
            raise err
        self._n_io_retries += 1
        if self.io_backoff > 0:
            time.sleep(self.io_backoff * (2 ** (self._io_streak - 1)))

    def _next_rank_doc(self) -> Optional[List[int]]:
        """Next tokenized document owned by this rank, advancing the cursor;
        None at end of the final allowed epoch."""
        while True:
            try:
                fh = self._open()
            except OSError as e:
                self._io_retry_or_raise(e)
                continue
            if fh is None:  # epoch exhausted
                if self.epochs is not None and self._epoch + 1 >= self.epochs:
                    return None
                self._epoch += 1
                self._file_idx = 0
                self._byte_offset = 0
                self._doc_count = 0
                self._rng = np.random.default_rng(self._epoch_seed(self._epoch))
                continue
            try:
                line = fh.readline()
            except OSError as e:
                self._io_retry_or_raise(e)
                continue
            self._io_streak = 0
            if not line:
                fh.close()
                self._fh = None
                self._file_idx += 1
                self._byte_offset = 0
                continue
            self._byte_offset = fh.tell()
            if not line.rstrip("\n"):
                continue  # blanks don't consume a document index
            idx = self._doc_count
            self._doc_count += 1
            if idx % self.world_size != self.rank:
                continue  # another rank's document: skip without parsing
            try:
                text = parse_doc_line(self.shards[self._file_idx], line)
            except (ValueError, KeyError, TypeError):
                # undecodable line (corrupt JSON / wrong schema): its index
                # was already consumed above, so every rank of any world
                # size skips this exact line — sharding stays aligned
                self._n_skipped_lines += 1
                continue
            ids = self.tokenizer.encode(text)
            if ids:
                return ids

    # ----------------------------------------------------------- batching

    def _make_anchor(self) -> Dict:
        """Snapshot of everything a restore needs to replay the current
        block: stream position, RNG, packer tail, and the pending windows
        left over from previous blocks. All O(1) in `shuffle_buffer`."""
        return {
            "epoch": self._epoch,
            "file_idx": self._file_idx,
            "byte_offset": self._byte_offset,
            "doc_count": self._doc_count,
            "rng_state": self._rng.bit_generator.state,
            "packer": self._packer.state_dict(),
            "pending": list(self._pending),  # window dicts are immutable
        }

    def _read_block(self) -> List[List[int]]:
        """Read up to `shuffle_buffer` documents and permute them with the
        stream RNG. Called both live (from `_pump`) and during replay, so
        the permutation is a pure function of the anchor state."""
        docs: List[List[int]] = []
        while len(docs) < self.shuffle_buffer:
            doc = self._next_rank_doc()
            if doc is None:
                self._exhausted = True
                break
            docs.append(doc)
        order = self._rng.permutation(len(docs)) if docs else []
        return [docs[i] for i in order]

    def _pump(self) -> bool:
        """Advance the pipeline one document; False when fully exhausted."""
        if not self._block:
            if self._exhausted:
                return False
            # new block: re-anchor the replay cursor BEFORE reading, then
            # read + permute (reversed so pop() yields permuted order)
            self._drained = 0
            self._windows_consumed = 0
            self._flushed_since_anchor = False
            self._anchor = self._make_anchor()
            self._block = self._read_block()[::-1]
            if not self._block:
                return False
        self._drained += 1
        self._pending.extend(self._packer.add_document(self._block.pop()))
        return True

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            while len(self._pending) < self.batch_size:
                if not self._pump():
                    break
            if len(self._pending) < self.batch_size and self._exhausted:
                if not self._block:
                    self._pending.extend(self._packer.flush())
                    self._flushed_since_anchor = True
                if len(self._pending) < self.batch_size:
                    return  # drop the ragged remainder: batch shape is static
            batch = examples_to_batch(self._pending[: self.batch_size])
            self._pending = self._pending[self.batch_size :]
            self._windows_consumed += self.batch_size
            self._batches_emitted += 1
            yield batch

    # -------------------------------------------------------------- state

    @staticmethod
    def _windows_to_json(windows) -> List[Dict]:
        return [
            {k: np.asarray(v).tolist() for k, v in ex.items()} for ex in windows
        ]

    @staticmethod
    def _windows_from_json(windows) -> List[Dict[str, np.ndarray]]:
        return [
            {
                k: np.asarray(v, bool if k == "valid" else np.int32)
                for k, v in ex.items()
            }
            for ex in windows
        ]

    def state_dict(self) -> Dict:
        return {
            "version": 2,
            # current read position: diagnostics + mid-shard visibility
            "epoch": self._epoch,
            "file_idx": self._file_idx,
            "byte_offset": self._byte_offset,
            "doc_count": self._doc_count,
            "batches_emitted": self._batches_emitted,
            "exhausted": self._exhausted,
            "io_retries": self._n_io_retries,
            "skipped_lines": self._n_skipped_lines,
            # offset-replay cursor: block anchor + consumed-prefix counters;
            # restore re-reads the block instead of storing its contents
            "anchor": {
                "epoch": self._anchor["epoch"],
                "file_idx": self._anchor["file_idx"],
                "byte_offset": self._anchor["byte_offset"],
                "doc_count": self._anchor["doc_count"],
                "rng_state": self._anchor["rng_state"],
                "packer": self._anchor["packer"],
                "pending": self._windows_to_json(self._anchor["pending"]),
            },
            "drained": self._drained,
            "windows_consumed": self._windows_consumed,
            "flushed": self._flushed_since_anchor,
        }

    def load_state_dict(self, state: Dict) -> None:
        assert state.get("version") == 2, state.get("version")
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        a = state["anchor"]
        self._epoch = int(a["epoch"])
        self._file_idx = int(a["file_idx"])
        self._byte_offset = int(a["byte_offset"])
        self._doc_count = int(a["doc_count"])
        self._rng = np.random.default_rng(0)
        self._rng.bit_generator.state = a["rng_state"]
        self._packer.load_state_dict(a["packer"])
        self._pending = self._windows_from_json(a["pending"])
        self._exhausted = False
        self._block = []
        drained = int(state["drained"])
        # replay: re-read the in-flight block from the anchor (re-deriving
        # buffer membership from the replayed RNG), re-feed the consumed
        # document prefix through the packer, drop already-emitted windows
        if drained > 0:
            permuted = self._read_block()
            for doc in permuted[:drained]:
                self._pending.extend(self._packer.add_document(doc))
            self._block = permuted[drained:][::-1]
        if bool(state.get("flushed", False)):
            self._pending.extend(self._packer.flush())
        wc = int(state["windows_consumed"])
        self._pending = self._pending[wc:]
        self._anchor = {
            "epoch": int(a["epoch"]),
            "file_idx": int(a["file_idx"]),
            "byte_offset": int(a["byte_offset"]),
            "doc_count": int(a["doc_count"]),
            "rng_state": a["rng_state"],
            "packer": dict(a["packer"]),
            "pending": self._windows_from_json(a["pending"]),
        }
        self._drained = drained
        self._windows_consumed = wc
        self._flushed_since_anchor = bool(state.get("flushed", False))
        # the replayed read must land exactly where the snapshot was taken
        assert (
            self._epoch == int(state["epoch"])
            and self._file_idx == int(state["file_idx"])
            and self._byte_offset == int(state["byte_offset"])
            and self._doc_count == int(state["doc_count"])
        ), "cursor replay diverged from the snapshotted stream position"
        self._batches_emitted = int(state["batches_emitted"])
        self._exhausted = bool(state["exhausted"])
        self._n_io_retries = int(state.get("io_retries", 0))
        self._n_skipped_lines = int(state.get("skipped_lines", 0))
        self._io_streak = 0
