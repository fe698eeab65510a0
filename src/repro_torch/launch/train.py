"""Training launcher of the port: BIP-balanced (or another paper method's)
training on the synthetic stream, on the GPU unless --device cpu.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minimind-moe-16e \
        --steps 20 --batch 16 --seq-len 512 [--strategy bip|topk|aux_loss|lossfree]

The expert FFN and the BIP dual update run in the CUDA kernels
(use_kernel=True). It prints one line per --log-every steps and, last, the
reference launcher's summary JSON (losses, AvgMaxVio/SupMaxVio, step
times, test_ppl on 4 held-out batches).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--strategy", "--method", dest="strategy", default=None,
                    help="routing strategy: any name in the port's balancer registry")
    ap.add_argument("--bip-iters", type=int, default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke-scale) variant of --arch")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out-json", default=None, help="write the run summary to this JSON file")
    ap.add_argument("--device", default="cuda", help="'cpu' runs without a GPU")
    args = ap.parse_args(argv)

    from repro_torch import configs, resolve_device
    from repro_torch.core import get_balancer
    from repro_torch.data import SyntheticBatchStream, make_batches
    from repro_torch.models import Model
    from repro_torch.training import evaluate_ppl, train_loop

    if args.strategy is not None:
        try:
            get_balancer(args.strategy)
        except ValueError as e:
            ap.error(str(e))
    device = resolve_device(args.device)
    cfg = configs.reduced_for_smoke(args.arch) if args.reduced else configs.get(args.arch)
    routing = dataclasses.replace(
        cfg.routing,
        strategy=args.strategy or cfg.routing.strategy,
        bip_iters=args.bip_iters or cfg.routing.bip_iters,
        use_kernel=True,
    )
    cfg = dataclasses.replace(cfg, routing=routing)
    model = Model(cfg, device=device)
    print(f"training {cfg.name} [{cfg.family}] method={cfg.routing.strategy} "
          f"sync={cfg.routing.sync} device={device} data=synthetic")
    batches = SyntheticBatchStream(cfg, args.batch, args.seq_len, args.steps, device=device)
    state, log = train_loop(
        model, batches, lr=args.lr, total_steps=args.steps, log_every=args.log_every
    )
    test = make_batches(cfg, args.batch, args.seq_len, 4, split="test", device=device)
    summary = {
        "arch": cfg.name,
        "method": cfg.routing.strategy,
        "sync": cfg.routing.sync,
        "device": str(device),
        "losses": log.losses,
        **log.summary(),
        "test_ppl": evaluate_ppl(model, state, test),
    }
    print(json.dumps(summary, indent=1, default=float))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(summary, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
