"""Continuous-batching serving engine (port of src/repro/serving/engine.py).

Requests are admitted from a FIFO queue into a fixed pool of batch slots;
every slot advances by up to `chunk_size` tokens per step through one
`Model.prefill_chunk` call — prefilling slots consume their next prompt
chunk, decoding slots their last sampled token, idle slots are masked out.
Per-slot cache positions let sequences at different offsets coexist, and
the BIP router's dual vector q threads through every step.

One row per slot: a prompt longer than a chunk prefills chunk by chunk, as
the reference engine does whenever its packed layout would not cut the
step count. The packed layout itself and the device mesh are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import get_balancer
from repro_torch.models.model import Model
from repro_torch.serving.scheduler import DECODE, PREFILL, Request, Scheduler
from repro_torch.telemetry.slo import ServingTelemetry


class ContinuousBatchingEngine:
    """Slot-pooled serving with chunked prefill fused into the decode step.

    Runs on `model.device`. `use_kernel` overrides the config's
    routing.use_kernel: True sends the expert FFN through the CUDA kernel
    pair (kernels/moe_gemm.py) without touching the config file.
    """

    def __init__(
        self,
        model: Model,
        params,
        *,
        n_slots: int = 8,
        chunk_size: int = 32,
        max_seq_len: int = 2048,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        max_waiting: int = 256,
        use_kernel: Optional[bool] = None,
        seed: int = 0,
        default_deadline: Optional[float] = None,
        queue_timeout: Optional[float] = None,
        shed_on_full: bool = False,
        step_delay: float = 0.0,
        clock=time.perf_counter,
        sink=None,
    ):
        cfg = model.cfg
        if use_kernel is not None and cfg.is_moe and use_kernel != cfg.routing.use_kernel:
            cfg = dataclasses.replace(
                cfg, routing=dataclasses.replace(cfg.routing, use_kernel=use_kernel)
            )
            model = Model(cfg, device=model.device)
        if cfg.is_moe and not get_balancer(cfg.routing.strategy).serving_ok:
            raise NotImplementedError(
                f"routing strategy {cfg.routing.strategy!r} is training-only; "
                "serve with a token-choice strategy instead"
            )
        if cfg.window_size and any(k == "local" for k, _ in cfg.layer_kinds()):
            # a chunk must fit the sliding-window ring buffer
            chunk_size = min(chunk_size, cfg.window_size, max_seq_len)
        self.model = model
        self.device = model.device
        self.params = params
        self.n_slots = n_slots
        self.chunk_size = chunk_size
        self.max_seq_len = max_seq_len
        self.eos_id = eos_id
        self.temperature = temperature
        # robustness knobs: `default_deadline` is a RELATIVE per-request
        # latency budget applied at submit; `clock` is injectable for
        # deterministic tests; `step_delay` is the slow_step fault hook
        self.default_deadline = default_deadline
        self.step_delay = step_delay
        self.clock = clock
        self.scheduler = Scheduler(
            n_slots,
            max_waiting=max_waiting,
            queue_timeout=queue_timeout,
            shed_on_full=shed_on_full,
        )
        self.cache = model.init_slot_cache(params, n_slots, max_seq_len)
        self.router_states = model.init_router_states()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.telemetry = ServingTelemetry(
            cfg.routing.n_experts if cfg.is_moe else 1, sink=sink
        )

    # ------------------------------------------- telemetry views

    @property
    def n_steps(self) -> int:
        return self.telemetry.n_steps

    @property
    def prefill_tokens(self) -> int:
        return self.telemetry.prefill_tokens

    @property
    def decode_tokens(self) -> int:
        return self.telemetry.decode_tokens

    @property
    def expert_load(self) -> np.ndarray:
        return self.telemetry.expert_load

    @property
    def max_vio_per_step(self) -> List[float]:
        return self.telemetry.max_vio_per_step

    @property
    def n_deadline_missed(self) -> int:
        return self.telemetry.n_deadline_missed

    @property
    def n_shed(self) -> int:
        return self.telemetry.n_shed

    # -------------------------------------------------------------- intake

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        eos_id: Optional[int] = None,
        ignore_eos: bool = False,
        arrival_time: float = 0.0,
        deadline: Optional[float] = None,
    ) -> Optional[Request]:
        """Queue one request. Returns it, or None under backpressure (bounded
        waiting queue full — retry after stepping the engine). `deadline` is
        a RELATIVE latency budget in seconds."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if len(prompt) >= self.max_seq_len:
            raise ValueError("prompt does not fit the cache")
        now = self.clock()
        budget = deadline if deadline is not None else self.default_deadline
        req = Request(
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            ignore_eos=ignore_eos,
            arrival_time=arrival_time,
            deadline=None if budget is None else now + budget,
        )
        return req if self.scheduler.submit(req, now) else None

    # ---------------------------------------------------------------- step

    def _observe(self, req: Request) -> Request:
        self.telemetry.on_finish(req, len(req.output))
        return req

    @torch.no_grad()
    def _serve_step(self, tokens: np.ndarray, lengths: np.ndarray):
        """One model step over the (n_slots, chunk) grid; returns the next
        token of every slot (sampled from its last real column) on the host,
        plus the step's metrics on the host."""
        dev = self.device
        tok = torch.as_tensor(tokens, dtype=torch.int64).to(dev)
        lens = torch.as_tensor(lengths, dtype=torch.int64).to(dev)
        logits, self.cache, self.router_states, mets = self.model.prefill_chunk(
            self.params, tok, self.cache, self.router_states, lens
        )
        idx = torch.clamp_min(lens - 1, 0)
        last = logits[torch.arange(logits.shape[0], device=dev), idx]
        if self.temperature > 0.0:
            probs = torch.softmax(last / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt.cpu().numpy(), {k: v.cpu().numpy() for k, v in mets.items()}

    def step(self) -> List[Request]:
        """One fused serve step. Returns requests completed this step —
        including any dropped by the deadline/timeout sweep or shed at
        submit, so every request's outcome is reported exactly once."""
        if self.step_delay > 0:
            time.sleep(self.step_delay)  # slow_step fault injection
        now = self.clock()
        dropped = [
            self._observe(r)
            for r in self.scheduler.expire(now) + self.scheduler.take_dropped()
        ]
        for slot_idx, _req in self.scheduler.admit(now):
            self.model.reset_slot(self.cache, slot_idx)

        b, c = self.n_slots, self.chunk_size
        active = list(self.scheduler.active())
        if not active:
            return dropped

        tokens = np.zeros((b, c), np.int64)
        lengths = np.zeros((b,), np.int64)
        plan = []  # (slot_idx, slot, kind, n_tokens)
        for i, slot in active:
            req = slot.request
            if not slot.prompt_done:
                chunk = req.prompt[slot.n_prefilled : slot.n_prefilled + c]
                tokens[i, : len(chunk)] = chunk
                lengths[i] = len(chunk)
                plan.append((i, slot, PREFILL, len(chunk)))
            else:
                tokens[i, 0] = req.output[-1]
                lengths[i] = 1
                plan.append((i, slot, DECODE, 1))
        nxt, mets = self._serve_step(tokens, lengths)
        self.telemetry.on_step(
            mets,
            n_prefill=sum(n for _, _, kind, n in plan if kind == PREFILL),
            n_decode=sum(1 for _, _, kind, _ in plan if kind == DECODE),
            queue_depth=len(self.scheduler.waiting),
        )

        done: List[Request] = dropped
        now = self.clock()
        for i, slot, kind, n_tok in plan:
            req = slot.request
            if kind == PREFILL:
                slot.n_prefilled += n_tok
                if not slot.prompt_done:
                    continue  # still mid-prompt: this step's sample is unused
                req.phase = DECODE
                req.t_first_token = now
            # the step that finishes the prompt doubles as the first decode
            tok = int(nxt[i])
            req.output.append(tok)
            eos = req.eos_id if req.eos_id is not None else self.eos_id
            if eos is not None and not req.ignore_eos and tok == eos:
                done.append(self._observe(self.scheduler.finish(i, "eos", now)))
            elif len(req.output) >= req.max_new_tokens:
                done.append(self._observe(self.scheduler.finish(i, "max_new_tokens", now)))
            elif slot.pos >= self.max_seq_len:
                done.append(self._observe(self.scheduler.finish(i, "length", now)))
        return done

    # ----------------------------------------------------------------- run

    def run(self, requests: Optional[Iterable[Request]] = None) -> List[Request]:
        """Drain: submit any extra `requests` (interleaving steps under
        backpressure), then step until no work remains. Returns the requests
        completed during this call, in completion order."""
        finished: List[Request] = []
        pending = list(requests) if requests is not None else []
        for req in pending:
            if len(req.prompt) >= self.max_seq_len:
                raise ValueError("prompt does not fit the cache")
        while pending:
            if self.scheduler.submit(pending[0], self.clock()):
                pending.pop(0)
            else:
                finished.extend(self.step())
        while self.scheduler.has_work:
            finished.extend(self.step())
        return finished
