"""Data of the port: the synthetic stream and the real-text pipeline
(tokenizer -> loader/packer -> prefetch to the GPU), as src/repro/data."""
from repro_torch.data.loader import BatchStream, ShardedTextLoader, resolve_shards
from repro_torch.data.packing import PACK_MODES, SequencePacker, examples_to_batch
from repro_torch.data.prefetch import Prefetcher, batch_to_torch
from repro_torch.data.synthetic import (
    SyntheticBatchStream,
    SyntheticLMDataset,
    frontend_stubs,
    make_batches,
)
from repro_torch.data.tokenizer import (
    ByteBPETokenizer,
    iter_corpus_texts,
    train_tokenizer_from_files,
)

__all__ = [
    "BatchStream",
    "ByteBPETokenizer",
    "PACK_MODES",
    "Prefetcher",
    "SequencePacker",
    "ShardedTextLoader",
    "SyntheticBatchStream",
    "SyntheticLMDataset",
    "batch_to_torch",
    "examples_to_batch",
    "frontend_stubs",
    "iter_corpus_texts",
    "make_batches",
    "resolve_shards",
    "train_tokenizer_from_files",
]
