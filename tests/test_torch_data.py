"""Port vs reference: the real-text data pipeline - the byte-level BPE
tokenizer, the packer and the rank-sharded loader with its cursor, the
prefetcher (on the CPU: no copy), the fault registry and the guard ladder.

Contract: everything here is integer or pure-Python state, so it is held
EXACTLY: the tokenizer's merges and every document's ids are equal, the
loader's batches (tokens, labels, segments) are bit-equal, its cursor is
JSON-equal, and a cursor saved by one package resumes the other bit-exactly.
"""
from __future__ import annotations

import itertools
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import loader as jax_loader  # noqa: E402
from repro.data import tokenizer as jax_tokenizer  # noqa: E402
from repro.robustness import faults as jax_faults  # noqa: E402
from repro.robustness import guards as jax_guards  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ByteBPETokenizer,
    Prefetcher,
    ShardedTextLoader,
    batch_to_torch,
    iter_corpus_texts,
    resolve_shards,
    train_tokenizer_from_files,
)
from repro_torch.robustness import faults, guards  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "corpus")
MODES = ("pack", "pack_nocross", "pad")


@pytest.fixture(scope="module")
def shards():
    return resolve_shards(FIXTURE)


@pytest.fixture(scope="module")
def toks(shards):
    """(reference tokenizer, port tokenizer), each trained on the corpus."""
    return (
        jax_tokenizer.train_tokenizer_from_files(shards, vocab_size=512),
        train_tokenizer_from_files(shards, vocab_size=512),
    )


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype


# ------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("vocab", [512, 6400])
def test_tokenizer_merges_and_ids_equal_reference(shards, vocab):
    """At the reduced and at minimind's vocab: the same merges in the same
    order, and the same ids for every document of the corpus."""
    tj = jax_tokenizer.train_tokenizer_from_files(shards, vocab_size=vocab)
    tt = train_tokenizer_from_files(shards, vocab_size=vocab)
    assert tt.merges == tj.merges and len(tt.merges) > 100
    assert (tt.vocab_size, tt.eos_id) == (tj.vocab_size, tj.eos_id) == (vocab, vocab - 1)
    texts = list(iter_corpus_texts(shards))
    assert len(texts) == 180
    for text in texts + ["", "ünïcode — 测试 🙂"]:
        ids = tt.encode(text)
        assert ids == tj.encode(text)
        assert tt.decode(ids) == text


def test_tokenizer_json_loads_across_packages(toks, tmp_path):
    tj, tt = toks
    tj.save(str(tmp_path / "ref.json"))
    tt.save(str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_text() == (tmp_path / "port.json").read_text()
    from_ref = ByteBPETokenizer.load(str(tmp_path / "ref.json"))
    from_port = jax_tokenizer.ByteBPETokenizer.load(str(tmp_path / "port.json"))
    text = next(iter_corpus_texts(resolve_shards(FIXTURE)))
    assert from_ref.encode(text) == tj.encode(text) == from_port.encode(text)
    assert from_ref.merges == from_port.merges == tt.merges


# ----------------------------------------------------------------- loader


def _loaders(toks, shards, **kw):
    tj, tt = toks
    kw = {"batch_size": 4, "seq_len": 32, "shuffle_buffer": 16, "seed": 3, **kw}
    return jax_loader.ShardedTextLoader(shards, tj, **kw), ShardedTextLoader(shards, tt, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_loader_batches_bit_equal(toks, shards, mode):
    lj, lt = _loaders(toks, shards, pack_mode=mode)
    got = list(itertools.islice(iter(lt), 12))
    for bj, bt in zip(itertools.islice(iter(lj), 12), got):
        _assert_batches_equal(bj, bt)
        assert ("segments" in bt) == (mode == "pack_nocross")
    assert len(got) == 12
    assert lt.state_dict() == lj.state_dict()


@pytest.mark.parametrize("mode", MODES)
def test_loader_cursor_json_equal_and_resumes_across_packages(toks, shards, mode):
    """Stop both mid-shard after 5 batches: the cursors are JSON-equal, and
    a cursor saved by either package resumes the other bit-exactly."""
    lj, lt = _loaders(toks, shards, pack_mode=mode)
    ij, it = iter(lj), iter(lt)
    for _ in range(5):
        next(ij), next(it)
    cj = json.loads(json.dumps(lj.state_dict()))
    ct = json.loads(json.dumps(lt.state_dict()))
    assert ct == cj and (cj["file_idx"] > 0 or cj["byte_offset"] > 0)
    ref = [next(ij) for _ in range(6)]
    rj, rt = _loaders(toks, shards, pack_mode=mode, seed=999)  # the seed must not matter
    rt.load_state_dict(cj)
    rj.load_state_dict(ct)
    for a, b, c in zip(ref, itertools.islice(iter(rt), 6), itertools.islice(iter(rj), 6)):
        _assert_batches_equal(a, b)
        _assert_batches_equal(a, c)


def test_loader_epoch_reshuffle_and_rank_striding_match(toks, shards):
    """Across the epoch boundary (the per-epoch reshuffle) the batches stay
    bit-equal; for world sizes 2 and 3 each rank owns the same documents."""
    lj, lt = _loaders(toks, shards, seq_len=64, shuffle_buffer=64, seed=0)
    ij, it = iter(lj), iter(lt)
    for _ in range(200):
        _assert_batches_equal(next(ij), next(it))
        if lt._epoch >= 1:
            break
    for _ in range(3):  # into the reshuffled second epoch
        _assert_batches_equal(next(ij), next(it))
    assert lt._epoch == lj._epoch >= 1 and lt.state_dict() == lj.state_dict()

    def rank_docs(cls, tok, rank, world):
        loader = cls(shards, tok, batch_size=1, seq_len=8, rank=rank, world_size=world,
                     epochs=1, seed=0)
        docs = []
        while (d := loader._next_rank_doc()) is not None:
            docs.append(d)
        return docs

    tj, tt = toks
    for world in (1, 2, 3):
        for rank in range(world):
            assert rank_docs(ShardedTextLoader, tt, rank, world) == rank_docs(
                jax_loader.ShardedTextLoader, tj, rank, world)


# -------------------------------------------------------------- prefetcher


def test_batch_to_torch_gives_int64_tensors(toks, shards):
    _, lt = _loaders(toks, shards, pack_mode="pack_nocross")
    batch = next(iter(lt))
    tb = batch_to_torch(batch)
    assert set(tb) == {"tokens", "labels", "segments"}
    for k, v in tb.items():
        assert v.dtype == torch.int64 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), batch[k])


def test_prefetcher_transparent_and_resumable(toks, shards):
    """On the CPU (no device to copy to) the prefetcher hands the stream's
    batches through unchanged, and its cursor counts the CONSUMED batches
    only, not the producer's read-ahead."""
    mk = lambda: _loaders(toks, shards)[1]  # noqa: E731
    raw = list(itertools.islice(iter(mk()), 10))
    pf = Prefetcher(mk(), depth=2, device="cpu")
    got = list(itertools.islice(iter(pf), 10))
    pf.close()
    for a, b in zip(raw, got):
        _assert_batches_equal(a, b)
    pf1 = Prefetcher(mk(), depth=2)
    it = iter(pf1)
    for _ in range(4):
        next(it)
    snap = json.loads(json.dumps(pf1.state_dict()))
    pf1.close()
    resumed = mk()
    resumed.load_state_dict(snap)
    _assert_batches_equal(raw[4], next(iter(resumed)))


def test_prefetcher_drains_cleanly_on_early_stop(toks, shards):
    before = threading.active_count()
    pf = Prefetcher(_loaders(toks, shards)[1], depth=2)
    for i, _ in enumerate(iter(pf)):
        if i == 2:
            break  # early stop mid-stream
    pf.close()
    assert pf._thread is None and threading.active_count() == before
    pf.close()  # double close is a no-op


def test_prefetcher_passes_producer_errors_on():
    class Boom:
        def __iter__(self):
            yield {"tokens": np.zeros((1, 4), np.int32)}
            raise RuntimeError("shard corrupted")

        def state_dict(self):
            return {}

        def load_state_dict(self, s):
            pass

    it = iter(Prefetcher(Boom(), depth=2))
    next(it)
    with pytest.raises(RuntimeError, match="shard corrupted"):
        next(it)


def test_prefetcher_retries_a_flaky_stream_bit_exactly(toks, shards):
    """A stream that fails before batches 2 and 5 (faults.FlakyStream):
    within the retry budget the batches are those of a clean stream."""
    clean = list(itertools.islice(iter(_loaders(toks, shards)[1]), 8))
    flaky = faults.parse_fault("flaky_stream@at=2,5")
    pf = Prefetcher(flaky.wrap(_loaders(toks, shards)[1]), depth=2, retries=1)
    got = list(itertools.islice(iter(pf), 8))
    pf.close()
    assert pf.n_producer_retries == 2
    for a, b in zip(clean, got):
        _assert_batches_equal(a, b)


# ------------------------------------------------------- faults and guards


def test_fault_specs_parse_as_in_reference():
    specs = ["nan_grad@step=3:6", "nan_grad@step=3,9", "ckpt_corrupt@step=1,mode=truncate",
             "flaky_open@p=0.3,p_read=0.1", "flaky_stream@at=2", "stall_prefetch@at=1,seconds=0.5",
             "slow_step@ms=5"]
    for spec in specs:
        assert faults.parse_fault(spec).describe() == jax_faults.parse_fault(spec).describe()
    assert sorted(faults.REGISTRY) == sorted(jax_faults.REGISTRY)
    plan, ref = faults.FaultPlan.from_specs(specs[:1]), jax_faults.FaultPlan.from_specs(specs[:1])
    assert [plan.nan_fires(i) for i in range(8)] == [ref.nan_fires(i) for i in range(8)]
    with pytest.raises(ValueError, match="unknown fault"):
        faults.parse_fault("nope@x=1")


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_guard_ladder_decisions_match_reference(policy):
    """The same observation sequence (a spike, a run of non-finite steps)
    through both guards: the same actions, controls and events."""
    kw = dict(policy=policy, spike_factor=3.0, spike_window=4, skips_before_lr_drop=2,
              max_rollbacks=8)
    gt = guards.TrainGuard(guards.GuardConfig(**kw), can_rollback=True)
    gj = jax_guards.TrainGuard(jax_guards.GuardConfig(**kw), can_rollback=True)
    obs = [(1.0, True), (0.9, True), (1.1, True), (1.0, True), (9.0, True), (float("nan"), False),
           (float("nan"), False), (1.0, True), (float("nan"), False), (0.8, True)]
    for step, (loss, ok) in enumerate(obs):
        assert gt.controls(step) == gj.controls(step)
        assert gt.observe(step, loss, ok) == gj.observe(step, loss, ok)
    assert json.dumps(gt.summary()) == json.dumps(gj.summary())
    with pytest.raises(guards.TrainingDiverged):
        guards.TrainGuard(guards.GuardConfig(policy="raise")).observe(0, float("nan"), False)
