"""Readings that the limits of a cell are set from, at the cell's own size,
in one process (the kernels are built and loaded once):

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --fault-seeds 3 [--first-seed N]

For each seed, the program's checked steps against the reference's (the
lower readings); on the first --control-seeds seeds the control, the
reference itself computed in fp8 in the program's place (reference/
'precision'), against the fp32 reference; on the first --fault-seeds seeds
the program with each fault of bench/faults.py. One JSON line per
reading on standard output, then the largest sound reading and the
smallest control and fault readings of each number.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from bench import check, faults, harness

    cell = harness.resolve(args.workload)
    rows = []

    def reading(kind, seed, prog_rec, ref_rec):
        nums = check.numbers(prog_rec, ref_rec)
        rows.append({"kind": kind, "seed": seed, **nums})
        print(json.dumps(rows[-1]), flush=True)

    def program(seed, fault=None):
        prog = harness.build_program(cell, seed, args.device)
        if fault is not None:
            prog.step = fault(prog.step)
        rec = harness.checked_steps(prog, cell, seed, args.device)
        pool = prog.pool
        del prog
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        return rec, pool

    for i in range(args.seeds):
        seed = args.first_seed + i
        rec, pool = program(seed)
        ref = harness.reference_records(cell, seed, pool, args.device)
        reading("program", seed, rec, ref)
        if i < args.control_seeds:
            reading("control_fp8", seed, harness.reference_records(cell, seed, pool, args.device, "fp8"), ref)
        if i < args.fault_seeds:
            for name in faults.FAULTS:
                reading(f"fault_{name}", seed, program(seed, faults.FAULTS[name])[0], ref)
    names = [n for n in rows[0] if n not in ("kind", "seed")]
    summary = {"lower": {n: max(r[n] for r in rows if r["kind"] == "program") for n in names}}
    for kind in sorted({r["kind"] for r in rows} - {"program"}):
        summary[kind] = {n: min(r[n] for r in rows if r["kind"] == kind) for n in names}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
