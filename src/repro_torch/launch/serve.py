"""Serving launcher of the port: load a reference checkpoint (or init fresh
from a seed) and serve a request stream through the continuous-batching
engine on the GPU. The grouped expert FFN runs in the CUDA kernels
(use_kernel=True).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minimind-moe-16e \
        --requests 16 --n-slots 8 --chunk 32 [--ckpt /path/step_N.npz]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _step_delay(specs) -> float:
    """Seconds of injected per-step delay from --inject specs. The port
    knows the one serving fault, 'slow_step@ms=N'."""
    delay = 0.0
    for spec in specs or ():
        name, _, rest = spec.partition("@")
        if name != "slow_step":
            raise ValueError(f"unknown serving fault {name!r}; known: ['slow_step']")
        ms = 10.0
        for kv in filter(None, rest.split(",")):
            k, _, v = kv.partition("=")
            if k.strip() != "ms":
                raise ValueError(f"bad fault parameter {kv!r} in {spec!r}")
            ms = float(v)
        delay = ms / 1e3
    return delay


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None, help="reference npz checkpoint")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq-len", type=int, default=0, help="0 = auto")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="'cpu' runs without a GPU")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget; overdue requests are "
                         "dropped ('expired') or evicted ('deadline')")
    ap.add_argument("--queue-timeout-ms", type=float, default=None,
                    help="max time a request may wait for admission")
    ap.add_argument("--shed-on-full", action="store_true",
                    help="under overload, shed the oldest waiting request "
                         "instead of refusing new submissions")
    ap.add_argument("--inject", action="append", default=None, metavar="SPEC",
                    help="fault injection: 'slow_step@ms=50' (decode slowdown "
                         "driving deadline misses)")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="stream per-request lifecycle records + the final "
                         "SLO summary to this .jsonl/.csv file")
    args = ap.parse_args(argv)

    from repro_torch import configs, resolve_device
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.telemetry import open_sink

    device = resolve_device(args.device)
    cfg = configs.reduced_for_smoke(args.arch) if args.reduced else configs.get(args.arch)
    model = Model(cfg, device=device)
    if args.ckpt:
        from repro_torch.convert import load_npz_params

        params = load_npz_params(args.ckpt, cfg, device)
    else:
        params = model.init(0)
    step_delay = _step_delay(args.inject)
    if step_delay:
        print(f"injecting: slow_step {step_delay * 1e3:g} ms per step")

    sink = open_sink(args.telemetry)
    max_seq_len = args.max_seq_len or (args.prompt_len + args.gen + 1)
    eng = ContinuousBatchingEngine(
        model,
        params,
        n_slots=args.n_slots,
        chunk_size=args.chunk,
        max_seq_len=max_seq_len,
        temperature=args.temperature,
        eos_id=args.eos_id,
        use_kernel=True,
        default_deadline=args.deadline_ms / 1e3 if args.deadline_ms else None,
        queue_timeout=args.queue_timeout_ms / 1e3 if args.queue_timeout_ms else None,
        shed_on_full=args.shed_on_full,
        step_delay=step_delay,
        sink=sink,
    )
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, (plen,))
        while True:
            r = eng.submit(prompt, args.gen, ignore_eos=args.eos_id is None)
            if r is not None:
                break
            eng.step()  # waiting queue full: drain a step, then retry
        reqs.append(r)
    eng.run()

    for r in reqs[:4]:
        print(f"req {r.req_id}: prompt[{len(r.prompt)}] -> {r.output} ({r.finish_reason})")
    total = eng.prefill_tokens + eng.decode_tokens
    print(
        f"served {len(reqs)} requests over {eng.n_slots} slots in {eng.n_steps} "
        f"steps ({total} tokens: {eng.prefill_tokens} prefill / {eng.decode_tokens} decode)"
    )
    if eng.n_deadline_missed or eng.n_shed:
        print(
            f"deadline misses: {eng.n_deadline_missed} "
            f"({eng.n_deadline_missed / max(len(reqs), 1):.1%}), "
            f"shed/timeout: {eng.n_shed}"
        )
    if cfg.is_moe:
        load = eng.expert_load
        mean = max(load.mean(), 1e-9)
        print(f"per-expert load: {load.astype(int).tolist()} (MaxVio {load.max()/mean - 1.0:.3f})")
    slo = eng.telemetry.emit_summary()
    print(
        f"SLO: ttft p50 {1e3 * slo['ttft']['p50']:.1f} ms / "
        f"p99 {1e3 * slo['ttft']['p99']:.1f} ms, "
        f"itl p50 {1e3 * slo['itl']['p50']:.1f} ms / "
        f"p99 {1e3 * slo['itl']['p99']:.1f} ms, "
        f"queue depth max {slo['queue_depth_max']}"
    )
    if sink is not None:
        sink.close()
        print(f"telemetry -> {args.telemetry}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
