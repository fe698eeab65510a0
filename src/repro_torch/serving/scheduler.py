"""Request scheduler for continuous batching (a copy of
src/repro/serving/scheduler.py, DESIGN.md §Serving).

Host-side and model-free: the scheduler owns the request lifecycle
(waiting → prefill → decode → done) and the mapping of requests onto a fixed
pool of batch slots; the engine owns the device state (slot caches, router
duals) and asks the scheduler what each slot should do next step.

Policies, kept deliberately simple and observable:
  * admission is FIFO from a bounded waiting queue (`submit` returns False
    when the queue is full — callers must back off, not silently drop;
    with `shed_on_full` the OLDEST waiting request is shed instead, so
    overload degrades gracefully rather than stalling fresh traffic);
  * a request holds exactly one slot from admission to completion;
  * eviction happens on EOS, on max_new_tokens, or when the slot's cache
    rows run out (prompt + generated == max_seq_len).

Robustness (DESIGN.md §Robustness): requests may carry an absolute
`deadline`; `expire(now)` sweeps both the waiting queue and the active
slots, finishing overdue requests with reason 'expired' (never admitted)
or 'deadline' (evicted mid-generation), and enforces `queue_timeout` on
waiting time (reason 'timeout'). Every dropped request still flows back
to the caller — through `finish`'s return or the `take_dropped()` buffer
— with its `finish_reason` telling the client exactly what happened.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Iterator, List, Optional, Sequence, Tuple

WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"


@dataclasses.dataclass
class Request:
    """One generation request and its accumulated results."""

    prompt: List[int]
    max_new_tokens: int
    req_id: int = -1
    arrival_time: float = 0.0
    eos_id: Optional[int] = None  # overrides the engine default; None = engine's
    ignore_eos: bool = False
    deadline: Optional[float] = None  # ABSOLUTE clock time; None = no deadline

    # lifecycle (scheduler/engine-owned)
    phase: str = WAITING
    output: List[int] = dataclasses.field(default_factory=list)
    # 'eos' | 'max_new_tokens' | 'length' — or a robustness outcome:
    # 'expired' (deadline passed while waiting), 'deadline' (evicted
    # mid-generation), 'timeout' (waited past queue_timeout), 'shed'
    # (dropped to admit fresh traffic under overload)
    finish_reason: Optional[str] = None
    t_submitted: float = 0.0
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        assert len(self.prompt) >= 1, "empty prompt"
        assert self.max_new_tokens >= 1


@dataclasses.dataclass
class Slot:
    """Host mirror of one device batch slot."""

    request: Request
    n_prefilled: int = 0  # prompt tokens already fed to the model

    @property
    def pos(self) -> int:
        """Next absolute cache position for this slot."""
        return self.n_prefilled + len(self.request.output)

    @property
    def prompt_done(self) -> bool:
        return self.n_prefilled >= len(self.request.prompt)


class Scheduler:
    """FIFO admission into a fixed pool of `n_slots` batch slots."""

    def __init__(
        self,
        n_slots: int,
        max_waiting: int = 256,
        queue_timeout: Optional[float] = None,
        shed_on_full: bool = False,
    ):
        assert n_slots >= 1
        self.n_slots = n_slots
        self.max_waiting = max_waiting
        self.queue_timeout = queue_timeout
        self.shed_on_full = shed_on_full
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Slot]] = [None] * n_slots
        self.n_completed = 0  # finished requests are returned, not retained
        self._ids = itertools.count()
        self._dropped: List[Request] = []  # expired/timed-out/shed, undrained

    # ------------------------------------------------------------ admission

    def submit(self, request: Request, now: float = 0.0) -> bool:
        """Queue a request; False = backpressure (waiting queue full).
        With `shed_on_full` the oldest WAITING request is shed to make room
        (graceful overload degradation: old queued work is the least likely
        to still meet its deadline) and submit always succeeds."""
        if len(self.waiting) >= self.max_waiting:
            if not self.shed_on_full:
                return False
            shed = self.waiting.popleft()
            self._drop(shed, "shed", now)
            self._dropped.append(shed)  # surfaced via take_dropped()
        if request.req_id < 0:
            request.req_id = next(self._ids)
        request.phase = WAITING
        request.t_submitted = now
        self.waiting.append(request)
        return True

    def _drop(self, req: Request, reason: str, now: float) -> None:
        req.phase = DONE
        req.finish_reason = reason
        req.t_done = now
        self.n_completed += 1

    def expire(self, now: float) -> List[Request]:
        """Sweep deadlines and queue timeouts. Evicts overdue ACTIVE slots
        (reason 'deadline'), drops overdue waiting requests ('expired') and
        ones queued past `queue_timeout` ('timeout'). Returns everything
        dropped by this sweep; evicted slots are free for re-admission."""
        out: List[Request] = []
        survivors: Deque[Request] = deque()
        for req in self.waiting:
            if req.deadline is not None and now >= req.deadline:
                self._drop(req, "expired", now)
                out.append(req)
            elif (
                self.queue_timeout is not None
                and now - req.t_submitted >= self.queue_timeout
            ):
                self._drop(req, "timeout", now)
                out.append(req)
            else:
                survivors.append(req)
        self.waiting = survivors
        for i, slot in list(self.active()):
            req = slot.request
            if req.deadline is not None and now >= req.deadline:
                out.append(self.finish(i, "deadline", now))
        return out

    def take_dropped(self) -> List[Request]:
        """Drain requests dropped outside an expire() call (shed on submit),
        so the engine can report every request's outcome exactly once."""
        out, self._dropped = self._dropped, []
        return out

    def admit(self, now: float = 0.0) -> List[Tuple[int, Request]]:
        """Move waiting requests into free slots, FIFO. Returns the newly
        occupied (slot_idx, request) pairs; the engine must reset those
        slots' cache rows before the next step."""
        admitted = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.waiting:
                req = self.waiting.popleft()
                req.phase = PREFILL
                req.t_admitted = now
                self.slots[i] = Slot(request=req)
                admitted.append((i, req))
        return admitted

    # ------------------------------------------------------------ lifecycle

    def active(self) -> Iterator[Tuple[int, Slot]]:
        for i, s in enumerate(self.slots):
            if s is not None:
                yield i, s

    def finish(self, slot_idx: int, reason: str, now: float = 0.0) -> Request:
        """Evict a slot's request (EOS / max-len): the slot frees for the
        next admission; the cache row is stale until the engine resets it.
        The finished request is returned to the caller, not retained (a
        long-running engine would otherwise grow without bound)."""
        slot = self.slots[slot_idx]
        assert slot is not None, f"slot {slot_idx} is empty"
        req = slot.request
        req.phase = DONE
        req.finish_reason = reason
        req.t_done = now
        self.slots[slot_idx] = None
        self.n_completed += 1
        return req

    # ------------------------------------------------------------- queries

    @property
    def n_free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    @property
    def n_active(self) -> int:
        return self.n_slots - self.n_free_slots

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or self.n_active > 0

    def __repr__(self) -> str:  # debugging aid
        occ = "".join("." if s is None else ("P" if not s.prompt_done else "D")
                      for s in self.slots)
        return (f"Scheduler(slots=[{occ}], waiting={len(self.waiting)}, "
                f"done={self.n_completed})")
