"""Paper reproduction of the port: the analogues of Tables 2 and 3 (the
counterpart of the reference's benchmarks/paper_repro.py), on the GPU
unless --device cpu.

    PYTHONPATH=src python -m repro_torch.launch.paper_repro --steps 150 --out repro.json
    PYTHONPATH=src python -m repro_torch.launch.paper_repro --device cpu --steps 4

Trains minimind-moe models at the paper's expert counts and layer pattern
(reduced width: d_model 128, 4 layers, seq 128, batch 8, vocab 512, as the
reference) with Loss-Controlled (aux_loss), Loss-Free and BIP at several
ADMM iteration counts T, through `balance_sweep.run_method`, and reports
AvgMaxVio / SupMaxVio / test perplexity / wall time:
  * Table 2 analogue, m=16 k=4: aux_loss, lossfree, bip at T 2/4/8;
  * Table 3 analogue, m=64 k=8: aux_loss, lossfree, bip at T 4/14.
Then the paper's four claims as PASS/FAIL lines, printed as the reference
prints them (BIP's AvgMaxVio and SupMaxVio lowest, balanced from the first
batch, perplexity competitive). The comparison is relative between methods
on one init and one stream. Results go to --out only (not BENCH_*.json).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Sequence

from repro_torch.launch.balance_sweep import check_out_path, run_method

TABLES = (
    ("minimind_moe_16e", (("aux_loss", 0), ("lossfree", 0), ("bip", 2), ("bip", 4), ("bip", 8)),
     "table2_m16_k4"),
    ("minimind_moe_64e", (("aux_loss", 0), ("lossfree", 0), ("bip", 4), ("bip", 14)),
     "table3_m64_k8"),
)


def repro_cfg(base_arch: str, *, d_model: int = 128, n_layers: int = 4, seq_len: int = 128):
    """The reference's paper_repro geometry: the real routing table, reduced
    width and depth."""
    from repro_torch import configs

    return dataclasses.replace(
        configs.get(base_arch), n_layers=n_layers, d_model=d_model, n_heads=4, n_kv_heads=4,
        head_dim=32, moe_d_ff=256, d_ff=256, vocab_size=512, max_seq_len=seq_len, attn_chunk=64,
    )


def run_one(base_arch: str, strategy: str, bip_iters: int, *, steps: int, seed: int = 0,
            d_model: int = 128, n_layers: int = 4, seq_len: int = 128, batch: int = 8,
            state=None, device="cuda") -> Dict:
    """One row: train `strategy` (bip at `bip_iters`), then test perplexity
    on 4 held-out synthetic batches. `state` (a TrainState of
    `repro_cfg(base_arch)`) replaces the init drawn from `seed`."""
    cfg = repro_cfg(base_arch, d_model=d_model, n_layers=n_layers, seq_len=seq_len)
    rec = run_method(cfg, strategy, steps, lr=1e-3, warmup_steps=10, batch=batch, seq_len=seq_len,
                     bip_iters=bip_iters or None, use_kernel=True, test_batches=4, state=state,
                     device=device, seed=seed)
    vio = rec["max_vio_per_step"]
    return {
        "strategy": strategy if strategy != "bip" else f"bip_T{bip_iters}",
        "AvgMaxVio": rec["AvgMaxVio"],
        "SupMaxVio": rec["SupMaxVio"],
        "perplexity": rec["test_ppl"],
        "train_wall_s": rec["train_wall_s"],
        "step_time_p50": rec["step_time_p50"],
        "AvgMaxVio_per_layer": rec["AvgMaxVio_per_layer"],
        "maxvio_trajectory": [max(row) for row in vio],
        "first_batch_maxvio": rec["first_step_max_vio"],
        "launches": rec["launches"],
    }


def table(base_arch: str, variants: Sequence, steps: int, tag: str, **kw) -> Dict:
    print(f"\n=== {tag} ({base_arch}, {steps} steps/method) ===", flush=True)
    rows = []
    for strategy, t in variants:
        r = run_one(base_arch, strategy, t, steps=steps, **kw)
        rows.append(r)
        print(f"{r['strategy']:<16} AvgMaxVio {r['AvgMaxVio']:<8.4f} SupMaxVio {r['SupMaxVio']:<8.4f} "
              f"ppl {r['perplexity']:<9.4f} wall {r['train_wall_s']:.1f}s "
              f"first-batch {r['first_batch_maxvio']:.4f}", flush=True)
    return {"table": tag, "arch": base_arch, "rows": rows}


def paper_checks(rows: List[Dict], baselines: Sequence[str] = ("aux_loss", "lossfree")) -> Dict[str, bool]:
    """The paper's claims over one table's rows (keys strategy, AvgMaxVio,
    SupMaxVio, first_batch_maxvio, perplexity): BIP's best row against the
    best of `baselines`, as the reference's checks."""
    by = {r["strategy"]: r for r in rows}
    bip_rows = [r for name, r in by.items() if name.startswith("bip")]
    base = [by[name] for name in baselines]
    return {
        "bip_avgmaxvio_lowest": min(r["AvgMaxVio"] for r in bip_rows) < min(r["AvgMaxVio"] for r in base),
        "bip_supmaxvio_lowest": min(r["SupMaxVio"] for r in bip_rows) < min(r["SupMaxVio"] for r in base),
        "bip_balanced_from_step1": any(
            r["first_batch_maxvio"] is not None and r["first_batch_maxvio"] < 0.6 for r in bip_rows),
        "bip_ppl_competitive": min(r["perplexity"] for r in bip_rows)
        <= 1.02 * min(r["perplexity"] for r in base),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="'cpu' runs without a GPU")
    ap.add_argument("--out", default=None, help="write the tables JSON here (not BENCH_*.json)")
    args = ap.parse_args(argv)
    try:
        check_out_path(args.out)
    except ValueError as e:
        ap.error(str(e))
    results = [table(arch, variants, args.steps, tag, device=args.device)
               for arch, variants, tag in TABLES]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
        print(f"\nwrote {args.out}")
    for tbl in results:
        for name, ok in paper_checks(tbl["rows"]).items():
            print(f"[{tbl['table']}] {name}: {'PASS' if ok else 'FAIL'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
