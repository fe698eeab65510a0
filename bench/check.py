"""The comparison that decides `correct`: the program's first training steps
against the plain reference's, from the same weights and batches.

Both sides give, for each of the checked steps, the loss, each router
layer's dual q and expert loads (none where the model has no router); the
norm of each leaf's gradient at step 1 as the optimizer takes it (after
clipping); and the norm of each leaf's change over the checked steps. The
numbers compared:

  loss_gap    max over steps of |loss - loss_ref| / |loss_ref|
  loss1_gap   the same at the first step alone, where both sides start
              from the same weights (later steps add the spread of two
              trajectories: Adam moves every weight by about lr times the
              sign of its gradient, and an element whose gradient is near
              zero takes either sign)
  grad_gap    max over leaves of | |g| - |g_ref| | / max(|g_ref|, median leaf's |g_ref|)
  update_gap  the same of the change, over the leaves whose reference
              gradient is at least 1e-3 of the median leaf's (a leaf below
              that moves under Adam by round-off alone)
  q1_gap      max over layers and experts of |q - q_ref| after the first step
  load1_gap   max over layers of sum_e |load - load_ref| / (2 n k) at the
              first step, the share of token-expert assignments that moved
              (n k, a layer's assignments, the sum of its reference loads;
              both at the first step, for loss1_gap's reason: over three
              steps they grow with the trajectories' spread, and the first
              separates the fp8 control from the program better)

Each has a limit of its own per cell (bench/limits/<cell>.json); a number
that is not finite, or that a limits file names and the run lacks, fails.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

UPDATE_LEAF_FLOOR = 1e-3


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _worst(gaps) -> float:
    """The largest gap; inf where any is not finite (max() would skip a NaN)."""
    gaps = [float(g) for g in gaps]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _norm_gap(got: List[float], want: List[float], keep: Optional[List[bool]] = None) -> float:
    keep = keep or [True] * len(want)
    base = _median([w for w, k in zip(want, keep) if k])
    return _worst(abs(g - w) / max(w, base) for g, w, k in zip(got, want, keep) if k)


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of a run (`prog`) against the reference (`ref`);
    both in reference.train_steps' record layout. q1_gap and load1_gap only
    where the model has router layers (records with q and loads)."""
    g_med = _median(ref["grad_norms"])
    keep = [g >= UPDATE_LEAF_FLOOR * g_med for g in ref["grad_norms"]]
    out = {
        "loss_gap": _worst(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
        "loss1_gap": _worst([abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])]),
        "grad_gap": _norm_gap(prog["grad_norms"], ref["grad_norms"]),
        "update_gap": _norm_gap(prog["update_norms"], ref["update_norms"], keep),
    }
    if ref["q"]:
        out["q1_gap"] = _worst([(prog["q"][0].float() - ref["q"][0].float()).abs().max()])
    if ref["load"]:
        assignments = int(ref["load"][0][0].sum())  # n k: a layer's loads count every assignment
        out["load1_gap"] = _worst([(prog["load"][0].long() - ref["load"][0].long()).abs().sum(-1).max()
                                   / (2 * assignments)])
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, dict]) -> bool:
    """True when every limited number is there, finite and within its limit."""
    return all(math.isfinite(nums.get(k, math.inf)) and nums[k] <= lim["limit"] for k, lim in limits.items())
