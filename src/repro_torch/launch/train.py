"""Training launcher of the port: BIP-balanced (or another paper method's)
training on the synthetic stream or on a real-text corpus, on the GPU
unless --device cpu.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minimind-moe-16e \
        --steps 20 --batch 16 --seq-len 512 [--strategy bip|topk|aux_loss|lossfree]

Real text (the reference's streaming pipeline, DESIGN.md §Data):

    PYTHONPATH=src python -m repro_torch.launch.train --arch minimind-moe-16e \
        --data tests/fixtures/corpus --pack-mode pack_nocross --micro 2 \
        --ckpt-dir ck --ckpt-every 6 --steps 12 [--resume] [--guard skip]

--data points at .jsonl ({"text": ...} per line) / .txt shards. The
tokenizer at --tokenizer is loaded if present, otherwise trained on the
corpus to the arch's vocab size and saved there (and copied into
--ckpt-dir). One GPU is rank 0 of 1. The loader's cursor is checkpointed
with the TrainState (the reference's npz format), and --resume continues
bit-exactly on the CPU. --prefetch N (0 disables) copies batches to the
GPU ahead of their step from pinned memory on a side stream.

The expert FFN and the BIP dual update run in the CUDA kernels
(use_kernel=True); --sync global switches the dual to the threshold
bisection (the reference's single-device sync='global' numerics, K3 off,
the expert FFN still on K1/K2), which --forecast warm-starts. It prints
one line per --log-every steps and, last, the reference launcher's summary
JSON (losses, AvgMaxVio/SupMaxVio, step times, and test_ppl on 4 held-out
synthetic batches or, with --data, train_corpus_ppl on 4 batches of the
training corpus).

Observability: --telemetry run.jsonl streams one record per step
(per-layer expert load histograms, MaxVio, dual health, guard events)
from a device ring drained every --flush-every steps; summarize it with
`python -m repro_torch.telemetry.metrics_report run.jsonl`. --profile N:M
writes a torch.profiler Chrome trace of steps N..M into ./profile.

Every --arch trains (the reference's twelve configurations): vlm and
encdec batches carry their seeded patch/frame stubs onto the device, and
ssm/hybrid models refuse --pack-mode pack_nocross, as the reference's (the
mamba recurrence would cross document boundaries).

A mesh (--mesh DxM: D-way data x M-way expert parallelism), one process
per rank:

    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
        --arch minimind-moe-16e --mesh 2x2 [--sync global]

Each rank binds cuda:{local rank % cards} (NCCL when every rank has a card
of its own, gloo when ranks share one; --device cpu: gloo on the CPU), cuts
the seeded global batch to its rows and the state to its blocks
(training.loop), the MoE layers take the config's expert-parallel path
(moe_impl; 'auto' = ep2ds, as the reference), and rank 0 prints the log
and the summary. On a mesh,
--sync global keeps K3 on: the dual runs in its collective form (counts
psum'd over the data ranks). --micro k splits the global batch into k
microbatches as on one device (each rank its rows of each). --ckpt-dir /
--ckpt-every / --resume write and read the same files as one device:
rank 0 writes the whole state gathered from the ranks, and a resume cuts
every rank's blocks from it, so a mesh run resumes on one device or on
another mesh shape and the other way round. Without torch.distributed.run
(or with another world size than D*M) --mesh is an argparse error. The
reference's TPU-pod flags
(--production, --multi-pod, --coordinator, --num-hosts, --host-id) are not
ported: they set up TPU pods.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import shutil
import sys


def _tokenizer(cfg, args, shards, lead=True):
    """Load --tokenizer when the file exists, else train one on the corpus
    to cfg.vocab_size and save it there; a copy lands in --ckpt-dir. On a
    mesh every rank trains the same tokenizer and only rank 0 (`lead`)
    writes and prints."""
    from repro_torch.data import ByteBPETokenizer, train_tokenizer_from_files

    tok_path = args.tokenizer or (
        os.path.join(args.ckpt_dir, "tokenizer.json") if args.ckpt_dir else None
    )
    if tok_path and os.path.exists(tok_path):
        tokenizer = ByteBPETokenizer.load(tok_path)
        if lead:
            print(f"tokenizer <- {tok_path} (vocab {tokenizer.vocab_size})")
    else:
        tokenizer = train_tokenizer_from_files(shards, vocab_size=cfg.vocab_size)
        if lead:
            print(f"tokenizer trained on {len(shards)} shard(s): "
                  f"{len(tokenizer.merges)} merges, vocab {tokenizer.vocab_size}")
        if tok_path and lead:
            tokenizer.save(tok_path)
            print(f"tokenizer -> {tok_path}")
    if tokenizer.vocab_size > cfg.vocab_size:
        raise ValueError(f"tokenizer vocab {tokenizer.vocab_size} exceeds model vocab {cfg.vocab_size}")
    if lead and args.ckpt_dir and tok_path != os.path.join(args.ckpt_dir, "tokenizer.json"):
        os.makedirs(args.ckpt_dir, exist_ok=True)
        dst = os.path.join(args.ckpt_dir, "tokenizer.json")
        if tok_path:
            shutil.copy(tok_path, dst)
        else:
            tokenizer.save(dst)
    return tokenizer


def _build_data_stream(cfg, args, device, faults=None, lead=True):
    """(BatchStream, tokenizer) for --data: loader (rank 0 of 1: on a mesh
    every rank reads the global batch) -> fault wrappers -> Prefetcher to
    `device`."""
    from repro_torch.data import Prefetcher, ShardedTextLoader, resolve_shards

    shards = resolve_shards(args.data)
    tokenizer = _tokenizer(cfg, args, shards, lead)
    stream = ShardedTextLoader(
        shards, tokenizer, batch_size=args.batch, seq_len=args.seq_len,
        pack_mode=args.pack_mode, rank=0, world_size=1,
        shuffle_buffer=args.shuffle_buffer, seed=args.data_seed,
        io_retries=args.io_retries,
        open_fn=faults.open_fn() if faults is not None else None,
    )
    if faults is not None:
        stream = faults.wrap_stream(stream)  # flaky_stream / stall_prefetch
    if args.prefetch > 0:
        stream = Prefetcher(stream, depth=args.prefetch, device=device, retries=args.io_retries)
    return stream, tokenizer


def main(argv=None, *, config_fields=None):
    """The CLI. `config_fields` (a caller's, not a flag: the reference's
    launcher has none for it) replaces fields of --arch's config before
    anything is built, e.g. {'remat': 'block'} for a model whose
    activations do not fit on the card otherwise."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--strategy", "--method", dest="strategy", default=None,
                    help="routing strategy: any name in the port's balancer registry")
    ap.add_argument("--bip-iters", type=int, default=None)
    ap.add_argument("--sync", default=None, choices=["local", "global"],
                    help="BIP dual sync: on one device 'global' switches the dual "
                         "solver to the threshold/bisection form (the reference's "
                         "mesh numerics, K3 off; the expert FFN stays on K1/K2)")
    ap.add_argument("--n-bisect", type=int, default=None,
                    help="bits of bisection resolution for the sync='global' "
                         "dual order statistic (default 26)")
    ap.add_argument("--bisect-fanout", type=int, default=None,
                    help="thresholds probed per fused bisection round "
                         "(default 32 -> 6 rounds)")
    ap.add_argument("--forecast", action="store_true",
                    help="carry the dual forecaster (EMA of the order "
                         "statistic) in router state and warm-start each "
                         "bisection with its predicted bracket")
    ap.add_argument("--forecast-decay", type=float, default=None)
    ap.add_argument("--forecast-margin", type=float, default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--micro", type=int, default=1,
                    help="microbatches per step (gradient accumulation)")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke-scale) variant of --arch")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (master params/moments stay fp32)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out-json", default=None, help="write the run summary to this JSON file")
    ap.add_argument("--device", default="cuda", help="'cpu' runs without a GPU")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the full TrainState every N steps (0 = only the final state)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint in --ckpt-dir and continue")
    # real-text data pipeline
    ap.add_argument("--data", default=None,
                    help="corpus dir / glob / file of .jsonl|.txt shards (default: synthetic stream)")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer JSON path; trained on --data and saved here if missing "
                         "(default: <ckpt-dir>/tokenizer.json)")
    ap.add_argument("--pack-mode", default="pack", choices=["pack", "pack_nocross", "pad"],
                    help="'pack' = EOS-joined stream, 'pack_nocross' adds within-document "
                         "attention/loss masking, 'pad' = one document per sequence")
    ap.add_argument("--shuffle-buffer", type=int, default=64,
                    help="documents held in the loader's shuffle buffer")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="prefetch queue depth (0 = tokenize/pack/copy inline)")
    ap.add_argument("--data-seed", type=int, default=0, help="loader shuffle seed")
    # robustness
    ap.add_argument("--guard", default=None, choices=["skip", "rollback", "raise"],
                    help="anomaly policy for a non-finite loss/grad (skip -> LR drop -> "
                         "rollback ladder, rollback, or raise)")
    ap.add_argument("--spike-factor", type=float, default=0.0,
                    help="loss-spike threshold as a multiple of the recent median "
                         "(0 disables; implies --guard skip when no policy is given)")
    ap.add_argument("--spike-window", type=int, default=8,
                    help="finite losses in the spike reference window")
    ap.add_argument("--inject", action="append", default=None, metavar="SPEC",
                    help="fault injection, repeatable: 'nan_grad@step=3', "
                         "'ckpt_corrupt@step=0,mode=bitflip', 'flaky_open@p=0.3', "
                         "'flaky_stream@at=2'; see repro_torch.robustness.faults")
    ap.add_argument("--io-retries", type=int, default=3,
                    help="consecutive shard open/read failures retried before the loader raises")
    ap.add_argument("--guard-duals", action="store_true",
                    help="router dual-health watchdog: reset a layer's "
                         "carried q / forecaster EMAs to safe init when "
                         "non-finite or runaway")
    # observability (DESIGN.md §Observability)
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="stream per-step metric records (per-layer expert "
                         "load histograms, MaxVio, dual health, guard "
                         "events) to this .jsonl/.csv file; summarize with "
                         "`python -m repro_torch.telemetry.metrics_report PATH`")
    ap.add_argument("--flush-every", type=int, default=10,
                    help="telemetry ring window: steps buffered on the device "
                         "between asynchronous host drains")
    ap.add_argument("--profile", default=None, metavar="N:M",
                    help="capture a torch.profiler trace of train steps [N, M] "
                         "into ./profile (Chrome trace format)")
    # mesh
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="D-way data x M-way expert-parallel mesh over the ranks of "
                         "torch.distributed.run (D*M processes)")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")

    from repro_torch import configs, resolve_device
    from repro_torch.core import get_balancer
    from repro_torch.data import ShardedTextLoader, SyntheticBatchStream, make_batches, resolve_shards
    from repro_torch.distributed import make_mesh_ctx
    from repro_torch.models import build_model
    from repro_torch.robustness import FaultPlan, GuardConfig
    from repro_torch.telemetry import Profiler, TrainTelemetry, open_sink, profile_window
    from repro_torch.training import evaluate_ppl, train_loop

    if args.strategy is not None:
        try:
            get_balancer(args.strategy)
        except ValueError as e:
            ap.error(str(e))
    window = profile_window(args.profile)  # a bad spec fails before any work
    mesh = None
    lead = True  # the rank that prints and writes
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_from_cli

        mesh, device = mesh_from_cli(ap, args.mesh, args.device)
        lead = dist.get_rank() == 0
    else:
        device = resolve_device(args.device)
    cfg = configs.reduced_for_smoke(args.arch) if args.reduced else configs.get(args.arch)
    cfg = dataclasses.replace(cfg, **(config_fields or {}))
    sync = args.sync or cfg.routing.sync
    routing = dataclasses.replace(
        cfg.routing,
        strategy=args.strategy or cfg.routing.strategy,
        bip_iters=args.bip_iters or cfg.routing.bip_iters,
        sync=sync,
        n_bisect=args.n_bisect or cfg.routing.n_bisect,
        bisect_fanout=args.bisect_fanout or cfg.routing.bisect_fanout,
        forecast=args.forecast or cfg.routing.forecast,
        forecast_decay=cfg.routing.forecast_decay if args.forecast_decay is None else args.forecast_decay,
        forecast_margin=cfg.routing.forecast_margin if args.forecast_margin is None else args.forecast_margin,
        guard_duals=args.guard_duals or cfg.routing.guard_duals,
        # without a mesh, sync='global' is the bisection dual (K3 off, K1/K2
        # on); on a mesh it is K3's collective form
        use_kernel=sync != "global" or mesh is not None,
        ffn_kernel=True,
    )
    cfg = dataclasses.replace(cfg, routing=routing)
    if args.bf16:
        import torch

        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    model = build_model(cfg, make_mesh_ctx(mesh), device=device)  # mesh None: one device
    mesh_shape = None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))
    if lead:
        print(f"training {cfg.name} [{cfg.family}] method={cfg.routing.strategy} "
              f"sync={cfg.routing.sync} device={device} mesh={mesh_shape} "
              f"moe_impl={cfg.routing.moe_impl if mesh is not None else None} micro={args.micro} "
              f"remat={cfg.remat} data={args.data or 'synthetic'}")
    faults = None
    if args.inject:
        faults = FaultPlan.from_specs(args.inject)
        print("injecting: " + "; ".join(f.describe() for f in faults.faults))
    guard = None
    if args.guard or args.spike_factor:
        guard = GuardConfig(policy=args.guard or "skip", spike_factor=args.spike_factor,
                            spike_window=args.spike_window)
    if args.data:
        batches, tokenizer = _build_data_stream(cfg, args, device, faults, lead)
    else:
        batches = SyntheticBatchStream(cfg, args.batch, args.seq_len, args.steps, device=device)
        if faults is not None:
            batches = faults.wrap_stream(batches)
    telemetry = sink = None
    if (args.telemetry or window) and lead:
        sink = open_sink(args.telemetry)
        telemetry = TrainTelemetry(
            sink=sink,
            flush_every=args.flush_every,
            run_meta={
                "arch": cfg.name,
                "strategy": cfg.routing.strategy if cfg.is_moe else None,
                "sync": cfg.routing.sync if cfg.is_moe else None,
                "steps": args.steps,
                "flush_every": args.flush_every,
            },
            profiler=Profiler(window) if window else None,
        )
    try:
        state, log = train_loop(
            model, batches, lr=args.lr, total_steps=args.steps,
            log_every=args.log_every if lead else 0,
            microbatches=args.micro, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every or (args.steps if args.ckpt_dir else 0),
            resume=args.resume, guard=guard, faults=faults, telemetry=telemetry, mesh=mesh,
        )
    finally:
        if sink is not None:
            sink.close()
            print(f"telemetry -> {args.telemetry}")
    if telemetry is not None and telemetry.profiler is not None and telemetry.profiler.trace_path:
        print(f"profile -> {telemetry.profiler.trace_path}")
    if args.data:
        # no held-out split: the eval pass re-reads the training shards with
        # another shuffle seed, so it is labelled train_corpus_ppl
        test = itertools.islice(ShardedTextLoader(
            resolve_shards(args.data), tokenizer, batch_size=args.batch, seq_len=args.seq_len,
            pack_mode=args.pack_mode, seed=args.data_seed + 1, epochs=1,
        ), 4)
    else:
        test = make_batches(cfg, args.batch, args.seq_len, 4, split="test", device=device)
    test_ppl = evaluate_ppl(model, state, test)  # a collective on a mesh: every rank runs it
    if mesh is not None:
        dist.destroy_process_group()
    if not lead:
        return 0
    summary = {
        "arch": cfg.name,
        "method": cfg.routing.strategy,
        "sync": cfg.routing.sync,
        "device": str(device),
        "mesh": mesh_shape,
        "microbatches": args.micro,
        "data": args.data,
        "pack_mode": args.pack_mode if args.data else None,
        "losses": log.losses,
        **log.summary(),
        ("train_corpus_ppl" if args.data else "test_ppl"): test_ppl,
    }
    print(json.dumps(summary, indent=1, default=float))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(summary, f, indent=1, default=float)
    if args.ckpt_dir:
        print(f"checkpoint -> {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
