"""Reading a torch.profiler trace of the traced steps into the records that
the per-layer metric readers (bench/metrics/) take, and the breakdown.

The traced steps run inside one `bench/window` span, after a step traced
and left out (the profiler's start-up). From the trace:

  window_s     the span's length (the host clock, to a final synchronise)
  kernels      every device kernel that started inside it: (name, seconds)
  busy_s       the union of the device's kernels, copies and sets inside it
  span_s       device seconds of the kernels launched under each program span
               (every span the launch call ran inside; kernels launched on
               autograd's thread in the backward belong to no span of the
               program)
  idle_gaps    device idle time inside the window, by what the host was
               doing when each gap began: the innermost op running then, on
               the thread that started one last, and the program span it ran in
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch

WINDOW_SPAN = "bench/window"
LAUNCHES = ("cudaLaunch", "cuLaunch")  # the runtime's and the driver's launch calls


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _spans_of(e, span_names) -> List[str]:
    """The spans `e` is or runs inside, innermost first."""
    out = []
    while e is not None:
        if e.name in span_names:
            out.append(e.name)
        e = e.cpu_parent
    return out


def read(prof) -> Dict:
    events = list(prof.events())
    window = [e for e in events if e.name == WINDOW_SPAN and not _is_device(e)]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} '{WINDOW_SPAN}' spans, not one")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    cpu = [e for e in events if not _is_device(e)]
    span_names = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    device = sorted(
        (e for e in events if _is_device(e) and e.name not in span_names
         and not getattr(e, "is_user_annotation", False) and w0 <= e.time_range.start <= w1),
        key=lambda e: e.time_range.start)
    kernels = [(e.name, e.time_range.elapsed_us() * 1e-6) for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]

    # the device's busy intervals, merged
    busy: List[Tuple[float, float]] = []
    for e in device:
        a, b = e.time_range.start, min(e.time_range.end, w1)
        if busy and a <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], b))
        else:
            busy.append((a, b))
    busy_us = sum(b - a for a, b in busy)

    # device time per program span: each kernel goes to the spans its
    # launch call ran inside (the runtime's launch event shares the kernel's
    # correlation id), so kernels launched outside any op (K1-K3 through
    # ctypes) count too
    launch_spans = {e.id: _spans_of(e, span_names) for e in cpu if e.name.startswith(LAUNCHES)}
    span_s: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        for name in set(launch_spans.get(e.id, ())):
            span_s[name] += e.time_range.elapsed_us() * 1e-6

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": kernels,
        "span_s": dict(span_s),
        "idle_gaps": _idle_by_host(busy, w0, w1, cpu, span_names),
    }


def _idle_by_host(busy, w0, w1, cpu, span_names) -> Dict[str, float]:
    """Idle seconds inside [w0, w1] by what the host was doing at each gap's start."""
    gaps = [(a, b) for a, b in zip([w0] + [e for _, e in busy], [s for s, _ in busy] + [w1]) if b > a]
    ops = sorted((e for e in cpu if e.name != WINDOW_SPAN and e.time_range.end > w0
                  and e.time_range.start < w1), key=lambda e: e.time_range.start)
    stacks: Dict[int, list] = collections.defaultdict(list)
    out: Dict[str, float] = collections.defaultdict(float)
    i = 0
    for a, b in gaps:
        while i < len(ops) and ops[i].time_range.start <= a:
            stacks[ops[i].thread].append(ops[i])
            i += 1
        live = []
        for st in stacks.values():
            while st and st[-1].time_range.end <= a:
                st.pop()
            if st:
                live.append(st[-1])
        if live:
            top = max(live, key=lambda e: e.time_range.start)
            spans = _spans_of(top, span_names - {WINDOW_SPAN})
            name = top.name if not spans or spans[0] == top.name else f"{spans[0]} > {top.name}"
        else:
            name = "host outside any op"
        out[name] += (b - a) * 1e-6
    return dict(out)


def breakdown(rec: Dict) -> Dict[str, list]:
    """The ten device ops with the most time and the ten host activities
    under the most device idle time, in seconds."""
    by_op: Dict[str, float] = collections.defaultdict(float)
    for name, s in rec["kernels"]:
        by_op[name] += s
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(rec["idle_gaps"])}
