"""Anomaly-guard policies for the training loop (a copy of
src/repro/robustness/guards.py; DESIGN.md §Robustness).

Two halves, split by where the decision must run:

* **In-graph** (training/loop.py): the guarded train step computes
  ``step_ok = isfinite(loss) & isfinite(grad_norm) & ~force_skip`` and
  selects the PRE-step state for every leaf when it is false — a non-finite
  step can never poison params, Adam moments, or router duals, and a
  host-forced skip is bit-identical to the step never having run.
* **Host-side** (this module): `TrainGuard` watches the per-step metrics
  and decides how to *respond* to an anomaly — the configurable
  skip-step -> reduce-LR -> rollback ladder, plus loss-spike windowing
  (spikes are finite, so their update has already been applied; the only
  recovery is a rollback to the last valid checkpoint).

Determinism contract: every decision is a pure function of the observed
metric sequence and the guard's own state. A step that triggered a
rollback lands in `skip_steps`, so the replay force-skips it — the
recovered trajectory is bit-identical to an uninterrupted run that skipped
the same step (tests/test_robustness.py proves this for the reference,
tests/test_torch_train.py for the port).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Optional, Set

# actions returned by TrainGuard.observe()
OK = "ok"
SKIP = "skip"          # state already preserved in-graph; just continue
ROLLBACK = "rollback"  # restore newest valid checkpoint, rewind data cursor
RAISE = "raise"        # unrecoverable: surface TrainingDiverged


class TrainingDiverged(RuntimeError):
    """Raised when the guard's recovery budget is exhausted (or policy
    'raise' sees its first anomaly)."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Anomaly policy for train_loop(guard=...).

    policy: response to a non-finite loss/grad —
      'skip'     keep the pre-step state and move on; persistent anomalies
                 climb the ladder (reduce LR, then roll back).
      'rollback' restore the newest *valid* checkpoint, rewind the data
                 cursor, and replay (the anomalous step is force-skipped on
                 replay so a deterministic fault cannot loop forever).
      'raise'    fail fast (CI-style).
    spike_factor: > 0 enables loss-spike detection: a finite loss above
      factor x median(recent window) is an anomaly. Spike updates are
      already applied when detected, so the response is 'rollback' when a
      checkpoint manager is available, else the spike is recorded only.
    spike_window: finite losses in the reference window (detection starts
      once the window is full).
    skips_before_lr_drop: consecutive skips before the LR scale is dropped.
    lr_drop: multiplier applied to the LR scale at each ladder escalation.
    min_lr_scale: below this the ladder escalates to rollback (or raise).
    max_rollbacks: total rollback budget; exhausted -> raise.
    """

    policy: str = "skip"
    spike_factor: float = 0.0
    spike_window: int = 8
    skips_before_lr_drop: int = 4
    lr_drop: float = 0.5
    min_lr_scale: float = 0.1
    max_rollbacks: int = 4

    def __post_init__(self):
        if self.policy not in (SKIP, ROLLBACK, RAISE):
            raise ValueError(f"unknown guard policy {self.policy!r}")
        if self.spike_factor and self.spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1 (or 0 to disable)")
        if not (0.0 < self.lr_drop < 1.0):
            raise ValueError("lr_drop must be in (0, 1)")


class TrainGuard:
    """Host-side anomaly monitor; one instance per train_loop run.

    Usage per step i:
        force_skip, lr_scale = guard.controls(i)   # -> step inputs
        ... run the (guarded) step ...
        action = guard.observe(i, loss, step_ok)   # -> OK/SKIP/ROLLBACK
    `observe` raises TrainingDiverged for the RAISE action so callers
    can't accidentally ignore it.
    """

    def __init__(self, cfg: GuardConfig, can_rollback: bool = False):
        self.cfg = cfg
        self.can_rollback = can_rollback
        self.lr_scale = 1.0
        self.skip_steps: Set[int] = set()     # force-skipped on (re)play
        self.rolled_back_from: Set[int] = set()
        self.n_skips = 0
        self.n_rollbacks = 0
        self._consecutive = 0
        self._window: deque = deque(maxlen=max(2, cfg.spike_window))
        self.events: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- inputs

    def controls(self, step: int):
        """(force_skip, lr_scale) for the step about to run."""
        return step in self.skip_steps, self.lr_scale

    # ------------------------------------------------------------ outputs

    def _event(self, step: int, kind: str, **detail) -> None:
        self.events.append({"step": int(step), "kind": kind, **detail})

    def _escalate(self, step: int) -> str:
        """Ladder: repeated anomalies drop the LR; LR floor -> rollback."""
        if self._consecutive % self.cfg.skips_before_lr_drop == 0:
            self.lr_scale *= self.cfg.lr_drop
            self._event(step, "lr_drop", lr_scale=self.lr_scale)
            if self.lr_scale < self.cfg.min_lr_scale:
                return self._rollback_or_raise(step)
        return SKIP

    def _rollback_or_raise(self, step: int) -> str:
        if not self.can_rollback:
            raise TrainingDiverged(
                f"anomaly at step {step} needs a rollback but no checkpoint "
                f"manager / rewindable stream is available"
            )
        if self.n_rollbacks >= self.cfg.max_rollbacks:
            raise TrainingDiverged(
                f"rollback budget ({self.cfg.max_rollbacks}) exhausted at "
                f"step {step}"
            )
        self.n_rollbacks += 1
        self.rolled_back_from.add(step)
        self.skip_steps.add(step)  # replay must not re-apply the bad step
        self._event(step, "rollback", count=self.n_rollbacks)
        return ROLLBACK

    def observe(self, step: int, loss: float, step_ok: bool) -> str:
        """Classify the step just run and return the recovery action."""
        forced = step in self.skip_steps
        if step_ok and not forced:
            # spike windowing (finite losses only)
            if (
                self.cfg.spike_factor
                and len(self._window) == self._window.maxlen
            ):
                ref = sorted(self._window)[len(self._window) // 2]
                if loss > self.cfg.spike_factor * max(ref, 1e-9):
                    self._event(step, "spike", loss=loss, median=ref)
                    if self.can_rollback:
                        return self._rollback_or_raise(step)
                    return OK  # update applied, nothing to undo: record only
            self._window.append(loss)
            self._consecutive = 0
            return OK

        if forced:
            # planned skip (replay of a rolled-back / skip-listed step)
            self.n_skips += 1
            self._event(step, "forced_skip")
            return SKIP

        # unplanned non-finite anomaly
        self._event(step, "nonfinite", loss=loss)
        if self.cfg.policy == RAISE:
            raise TrainingDiverged(f"non-finite loss/grad at step {step}")
        if self.cfg.policy == ROLLBACK:
            return self._rollback_or_raise(step)
        # policy 'skip': in-graph select already preserved the state
        self.n_skips += 1
        self.skip_steps.add(step)  # deterministic on any later replay
        self._consecutive += 1
        return self._escalate(step)

    # ------------------------------------------------------------ summary

    def summary(self) -> Dict[str, Any]:
        return {
            "n_skips": self.n_skips,
            "n_rollbacks": self.n_rollbacks,
            "lr_scale": self.lr_scale,
            "skip_steps": sorted(self.skip_steps),
            "events": list(self.events),
        }


__all__ = [
    "GuardConfig",
    "OK",
    "RAISE",
    "ROLLBACK",
    "SKIP",
    "TrainGuard",
    "TrainingDiverged",
]
