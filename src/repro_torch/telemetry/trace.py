"""Tracing plane: span annotations and profiler capture windows (port of
src/repro/telemetry/trace.py).

One naming convention, "area/phase", lowercase, slash separated (e.g.
"router/score_adjust", "moe/gemm", "train/fwd_bwd"). The reference has two
span kinds, one that names traced ops inside jit and one for host-side
Python phases; the port is eager, so both names give a
`torch.profiler.record_function` span, a host range on the profiler's
timeline that the kernels launched under it are attributed to. Outside a
capture a span records nothing and launches nothing.

`profile_window("N:M")` parses the launchers' `--profile` flag; `Profiler`
starts a `torch.profiler.profile` when the step counter enters [N, M],
stops after M and writes a Chrome trace, so a capture costs nothing
outside its window.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch


def named_span(name: str):
    """Profiler span around the ops a phase launches (the reference's
    in-graph scope)."""
    return torch.profiler.record_function(name)


def trace_span(name: str):
    """Profiler span around a host-side phase (engine step, flush)."""
    return torch.profiler.record_function(name)


def profile_window(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse a --profile 'N:M' flag into an inclusive (start, stop) window."""
    if not spec:
        return None
    try:
        lo_s, hi_s = spec.split(":")
        lo, hi = int(lo_s), int(hi_s)
    except ValueError as e:
        raise ValueError(f"--profile expects 'N:M' (got {spec!r})") from e
    if lo < 0 or hi < lo:
        raise ValueError(f"--profile window must satisfy 0 <= N <= M (got {spec!r})")
    return lo, hi


class Profiler:
    """Capture a torch.profiler trace of steps N..M (inclusive).

    Call `step(i)` with the current step index before each step; the
    capture starts on entering the window and stops when a step past it
    begins (or at `close()` if the run ends inside it), then writes
    `<log_dir>/steps_N-M.pt.trace.json` (Chrome trace format; `trace_path`
    holds the name). Device activity is recorded when CUDA is available.
    Idempotent and inert when window is None.
    """

    def __init__(self, window: Optional[Tuple[int, int]], log_dir: str = "profile"):
        self.window = window
        self.log_dir = log_dir
        self.trace_path: Optional[str] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self, i: int) -> None:
        if self.window is None:
            return
        lo, hi = self.window
        if not self.active and lo <= i <= hi:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.log_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif self.active and i > hi:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's kernels end inside the capture
        prof, self._prof = self._prof, None
        prof.stop()
        lo, hi = self.window
        self.trace_path = os.path.join(self.log_dir, f"steps_{lo}-{hi}.pt.trace.json")
        prof.export_chrome_trace(self.trace_path)


__all__ = ["Profiler", "named_span", "profile_window", "trace_span"]
