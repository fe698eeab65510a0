"""Deterministic, seedable fault-injection registry (a copy of
src/repro/robustness/faults.py; DESIGN.md §Robustness).

Every guard in the robustness layer is only as trustworthy as the failure
it was tested against, so faults are first-class objects: parseable from a
CLI spec string, deterministic given their parameters (all randomness comes
from a seeded `np.random.default_rng`), and scoped to exactly one seam of
the system. The registry contract:

* A fault is registered under a short name and constructed from keyword
  parameters: ``parse_fault("nan_grad@step=3")`` ->
  ``NanGrad(step=3)``. Values parse as int, then float, then str.
* A fault NEVER fires outside the seam it documents (e.g. `NanGrad` only
  flips the injection scalar the guarded train step consumes; it does not
  touch model code).
* Firing is a pure function of the fault's own state + the call arguments,
  so a replay after rollback sees the *same* faults at the same step
  indices — which is exactly what makes rollback-recovery testable.

Seams:

  nan_grad       train step    scales the loss by NaN at given step(s)
  ckpt_corrupt   checkpoint    bit-flips / truncates the written npz
  flaky_open     data loader   shard open/read raises OSError (bounded run)
  flaky_stream   prefetcher    wrapped stream raises at given batch indices
  stall_prefetch prefetcher    producer sleeps before given batch indices
  slow_step      serving       per-engine-step delay (drives deadline misses)

`FaultPlan` bundles the faults of one run and answers the questions the
harness asks ("does a NaN fire at step i?", "wrap this stream", ...).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Type

import numpy as np

REGISTRY: Dict[str, Type["Fault"]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        REGISTRY[name] = cls
        return cls

    return deco


class Fault:
    """Base class; subclasses are dataclasses with keyword parameters."""

    name = "fault"

    def describe(self) -> str:
        params = ",".join(
            f"{f.name}={getattr(self, f.name)}" for f in dataclasses.fields(self)
        )
        return f"{self.name}@{params}" if params else self.name


def _parse_value(v: str) -> Any:
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            continue
    return v


def _parse_steps(steps) -> List[int]:
    """'3' / '3:7' (every step in [3,7)) / '3,9' -> sorted step indices."""
    if isinstance(steps, int):
        return [steps]
    out: List[int] = []
    for part in str(steps).split(","):
        if ":" in part:
            lo, hi = part.split(":")
            out.extend(range(int(lo), int(hi)))
        else:
            out.append(int(part))
    return sorted(set(out))


def parse_fault(spec: str) -> Fault:
    """'name@k=v,k2=v2' -> registered Fault instance."""
    name, _, rest = spec.partition("@")
    if name not in REGISTRY:
        raise ValueError(
            f"unknown fault {name!r}; registered: {sorted(REGISTRY)}"
        )
    params = {}
    if rest:
        # ',' separates parameters AND continues list values: a segment
        # without '=' extends the previous value ('step=3,7' -> step='3,7')
        pairs: List[str] = []
        for seg in rest.split(","):
            if "=" in seg:
                pairs.append(seg)
            elif pairs:
                pairs[-1] += "," + seg
            else:
                raise ValueError(f"bad fault parameter {seg!r} in {spec!r}")
        for kv in pairs:
            k, _, v = kv.partition("=")
            if not k:
                raise ValueError(f"bad fault parameter {kv!r} in {spec!r}")
            params[k.strip()] = _parse_value(v.strip())
    return REGISTRY[name](**params)


# ----------------------------------------------------------- train faults


@register("nan_grad")
@dataclasses.dataclass
class NanGrad(Fault):
    """Poison the loss (hence every gradient) at the given step index(es).

    `step` accepts '3', '3,9', or a '3:7' range. Deterministic by step
    index, so a rollback-replay that re-executes the step re-injects the
    same NaN — the guard must converge anyway (skip-set semantics).
    """

    step: Any = 0

    def __post_init__(self):
        self._steps = set(_parse_steps(self.step))

    def fires(self, step: int) -> bool:
        return int(step) in self._steps


@register("ckpt_corrupt")
@dataclasses.dataclass
class CkptCorrupt(Fault):
    """Corrupt a just-written checkpoint file (simulated bitrot/partial
    write). `step` indexes saves in save order (0 = first save of the run);
    mode 'bitflip' XORs one byte, 'truncate' cuts the file roughly in half.
    """

    step: Any = 0
    mode: str = "bitflip"
    seed: int = 0

    def __post_init__(self):
        assert self.mode in ("bitflip", "truncate"), self.mode
        self._steps = set(_parse_steps(self.step))
        self._rng = np.random.default_rng(self.seed)
        self._n_saves = 0

    def fires_for_save(self) -> bool:
        """Call once per completed save; True when this save is a target."""
        idx = self._n_saves
        self._n_saves += 1
        return idx in self._steps

    def corrupt(self, path: str) -> None:
        corrupt_file(path, mode=self.mode, rng=self._rng)


def corrupt_file(path: str, mode: str = "bitflip", rng=None) -> None:
    """Flip one byte / truncate `path` in place (test + injection helper)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return
    # bitflip somewhere past the zip local header so np.load still opens
    # the archive and the damage lands in array payload or its zip CRC
    off = int(rng.integers(min(64, size - 1), size))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


# ------------------------------------------------------------ data faults


@register("flaky_open")
@dataclasses.dataclass
class FlakyOpen(Fault):
    """An `open()` substitute whose opens/reads fail with probability `p`,
    never more than `max_consecutive` times in a row — so a loader with a
    retry budget >= max_consecutive always makes progress.
    """

    p: float = 0.5
    p_read: float = 0.0
    max_consecutive: int = 2
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._consecutive = 0
        self.n_open_failures = 0
        self.n_read_failures = 0

    def _should_fail(self, p: float) -> bool:
        if self._consecutive >= self.max_consecutive:
            self._consecutive = 0
            return False
        if self._rng.random() < p:
            self._consecutive += 1
            return True
        self._consecutive = 0
        return False

    def __call__(self, path, *args, **kwargs):
        if self._should_fail(self.p):
            self.n_open_failures += 1
            raise OSError(f"injected flaky open: {path}")
        fh = open(path, *args, **kwargs)
        return _FlakyHandle(fh, self) if self.p_read > 0 else fh


class _FlakyHandle:
    """File-handle proxy whose readline() fails per the owning FlakyOpen."""

    def __init__(self, fh, fault: FlakyOpen):
        self._fh = fh
        self._fault = fault

    def readline(self, *a):
        if self._fault._should_fail(self._fault.p_read):
            self._fault.n_read_failures += 1
            raise OSError("injected flaky read")
        return self._fh.readline(*a)

    def __getattr__(self, name):
        return getattr(self._fh, name)


@register("flaky_stream")
@dataclasses.dataclass
class FlakyStream(Fault):
    """Wrap a BatchStream so iteration raises OSError just before yielding
    the given global batch indices — each index fires exactly once, so a
    producer that restarts iteration (Prefetcher retry budget) recovers.
    """

    at: Any = 0

    def __post_init__(self):
        self._pending = set(_parse_steps(self.at))
        self._count = 0

    def wrap(self, stream):
        return _FaultyStream(stream, self)

    def before_batch(self) -> None:
        idx = self._count
        if idx in self._pending:
            self._pending.discard(idx)
            raise OSError(f"injected stream fault before batch {idx}")

    def on_batch(self) -> None:
        self._count += 1


@register("stall_prefetch")
@dataclasses.dataclass
class StallPrefetch(Fault):
    """Sleep `seconds` before yielding the given batch indices (producer
    stall: exercises consumer-side patience / close-while-stalled paths)."""

    at: Any = 0
    seconds: float = 0.2

    def __post_init__(self):
        self._steps = set(_parse_steps(self.at))
        self._count = 0

    def wrap(self, stream):
        return _FaultyStream(stream, self)

    def before_batch(self) -> None:
        if self._count in self._steps:
            time.sleep(self.seconds)

    def on_batch(self) -> None:
        self._count += 1


class _FaultyStream:
    """BatchStream proxy that consults a fault before/after each batch.

    The fault's counter advances only when a batch is actually yielded, so
    a retry after an injected failure re-attempts the SAME batch index —
    matching how a real flaky source behaves under retry.
    """

    def __init__(self, stream, fault):
        self.stream = stream
        self.fault = fault

    def __iter__(self):
        it = iter(self.stream)
        while True:
            self.fault.before_batch()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.fault.on_batch()
            yield batch

    def state_dict(self):
        return self.stream.state_dict()

    def load_state_dict(self, state):
        self.stream.load_state_dict(state)

    def close(self):
        if hasattr(self.stream, "close"):
            self.stream.close()


# --------------------------------------------------------- serving faults


@register("slow_step")
@dataclasses.dataclass
class SlowStep(Fault):
    """Delay every engine step by `ms` milliseconds (decode slowdown /
    head-of-line blocking: drives real-clock deadline misses)."""

    ms: float = 10.0

    @property
    def seconds(self) -> float:
        return self.ms / 1e3


# -------------------------------------------------------------- the plan


class FaultPlan:
    """The faults of one run, queried by the harness at each seam."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults = list(faults)

    @classmethod
    def from_specs(cls, specs: Optional[Iterable[str]]) -> "FaultPlan":
        return cls([parse_fault(s) for s in (specs or [])])

    def get(self, name: str) -> Optional[Fault]:
        for f in self.faults:
            if f.name == name:
                return f
        return None

    def __bool__(self) -> bool:
        return bool(self.faults)

    # seam queries --------------------------------------------------------

    def nan_fires(self, step: int) -> bool:
        f = self.get("nan_grad")
        return bool(f and f.fires(step))

    def corrupt_after_save(self, path: str) -> bool:
        """Apply a pending ckpt_corrupt fault to `path`; True if fired."""
        f = self.get("ckpt_corrupt")
        if f is not None and f.fires_for_save():
            f.corrupt(path)
            return True
        return False

    def open_fn(self):
        """Loader open() substitute, or None when no flaky_open fault."""
        return self.get("flaky_open")

    def wrap_stream(self, stream):
        for f in self.faults:
            if isinstance(f, (FlakyStream, StallPrefetch)):
                stream = f.wrap(stream)
        return stream

    def step_delay(self) -> float:
        f = self.get("slow_step")
        return f.seconds if f else 0.0


__all__ = [
    "CkptCorrupt",
    "Fault",
    "FaultPlan",
    "FlakyOpen",
    "FlakyStream",
    "NanGrad",
    "REGISTRY",
    "SlowStep",
    "StallPrefetch",
    "corrupt_file",
    "parse_fault",
    "register",
]
