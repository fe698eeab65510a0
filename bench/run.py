"""The benchmark of the port's training step: one cell, one run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. --trace 0 measures the cell's end-to-end
metrics over a window of --seconds; --trace 1 traces the mix's traced steps
and reports the per-layer metrics. Either way the run's first training
steps are compared with the plain reference (bench/check.py). The last line
of standard output is the result as one JSON object; the last lines of
standard error are the compared numbers beside their limits. Exits 2 without
a result where CUDA or the cell's cards are missing, 3 where a JAX module
(or the JAX package) was loaded.
"""
import time

T_FIRST = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def process_start() -> float:
    """time.monotonic() when this process started: its start time after boot
    (/proc/self/stat, in clock ticks) against CLOCK_BOOTTIME; the first
    statement of this file where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return T_FIRST
    start = time.monotonic() - age
    return start if 0 <= T_FIRST - start < 60 else T_FIRST


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else \
        f"nvidia-smi exited {res.returncode}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch

    from bench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    print(f"card: {card_line()}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (the benchmark runs the port alone)", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    print("\n".join(harness.check_lines(result)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
