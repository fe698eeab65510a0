"""Continuous-batching serving engine (port of src/repro/serving/engine.py).

Requests are admitted from a FIFO queue into a fixed pool of batch slots;
every slot advances by up to `chunk_size` tokens per step through one
`Model.prefill_chunk` call — prefilling slots consume their next prompt
chunk, decoding slots their last sampled token, idle slots are masked out.
Per-slot cache positions let sequences at different offsets coexist, and
the BIP router's dual vector q threads through every step.

PACKED prefill decouples batch rows from cache slots, as the reference's
engine does: when a prompt has more than a chunk left and rows would idle,
its next chunks SPREAD across the free rows (all-global stacks only:
write-then-attend makes this exact), and short fresh prompts tuck into
other rows' padding columns as extra segments to free more rows. The
packed step runs only when it spreads; otherwise the one-row-per-slot
step runs unchanged.

`mesh=` (a DeviceMesh from launch.mesh.make_host_mesh; one process per
rank, every rank builds the engine with the same arguments) serves on the
mesh as the reference engine does: the model is rebuilt on it, the expert
weights and the slot cache are cut to the rank's blocks with the training
layouts (distributed.param_specs, distributed.cache_specs), every other
weight is held whole on every rank (Model.serving_param_specs), the router
states stay replicated, and every step's operands are whole on every rank (see
models.model for the attention, the mamba layers and the MoE layers). Every
layout cache_specs gives the slot cache is served: slots, cache length or
neither over the data ranks; KV heads, head_dim or neither, SSM heads or
state N, conv channels over the model ranks. Every rank then takes
the same host decisions: the planner is deterministic, greedy ids are
computed from logits that are the same on every rank, and with
temperature > 0 rank 0 samples and broadcasts the ids (one small
collective per step). Only rank 0 writes the sink and the profile.

`greedy_generate` is the reference's batched greedy decoding: through the
engine for the token families, through the per-token path
(`_legacy_generate`) for encdec and vlm models and for any request that
carries side inputs (frames, patches), as the reference routes them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import get_balancer
from repro_torch.models.model import Model
from repro_torch.serving.scheduler import DECODE, PREFILL, Request, Scheduler
from repro_torch.telemetry.slo import ServingTelemetry
from repro_torch.telemetry.trace import Profiler, trace_span

Tensor = torch.Tensor


class ContinuousBatchingEngine:
    """Slot-pooled serving with chunked prefill fused into the decode step.

    Runs on `model.device`. `use_kernel` overrides the config's
    routing.use_kernel: True sends the expert FFN through the CUDA kernel
    pair (kernels/moe_gemm.py) without touching the config file. `mesh`
    serves on a device mesh (see the module doc); `params` are then the
    whole params, cut here. It serves what one device serves, with any
    `n_slots`.
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
        profile=None,
        profile_dir: str = "profile",
        mesh=None,
    ):
        cfg = model.cfg
        if use_kernel is not None and cfg.is_moe and use_kernel != cfg.routing.use_kernel:
            cfg = dataclasses.replace(
                cfg, routing=dataclasses.replace(cfg.routing, use_kernel=use_kernel)
            )
            model = Model(cfg, device=model.device)
        if mesh is not None:
            import torch.distributed as dist

            from repro_torch.distributed import make_mesh_ctx, shard_tree
            from repro_torch.models.model import build_model

            model = build_model(cfg, make_mesh_ctx(mesh), device=model.device)
            params = shard_tree(params, model.serving_param_specs(), mesh)
            if dist.get_rank() != 0:  # rank 0 writes the sink and the profile
                sink, profile = None, None
        if cfg.is_moe and not get_balancer(cfg.routing.strategy).serving_ok:
            raise NotImplementedError(
                f"routing strategy {cfg.routing.strategy!r} is training-only; "
                "serve with a token-choice strategy instead"
            )
        if cfg.window_size and any(k == "local" for k, _ in cfg.layer_kinds()):
            # a chunk must fit the sliding-window ring buffer
            chunk_size = min(chunk_size, cfg.window_size, max_seq_len)
        self.model = model
        self.mesh = mesh
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
        # packed-prefill gates: packing needs segment-aware attention on
        # every layer (no SSM/conv state, which advances strictly left to
        # right per row); spreading one stream across rows also needs the
        # write-then-attend cache on every layer (no sliding-window rings)
        kinds = [k.replace("+shared", "") for k, _ in cfg.layer_kinds()]
        self._can_pack = all(k in ("global", "local") for k in kinds)
        self._can_spread = self._can_pack and all(k == "global" for k in kinds)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.telemetry = ServingTelemetry(
            cfg.routing.n_experts if cfg.is_moe else 1, sink=sink
        )
        # `profile` = (lo, hi): the serve steps captured with torch.profiler
        self.profiler = Profiler(profile, log_dir=profile_dir) if profile is not None else None

    def close(self) -> None:
        """Stop an in-flight profiler capture (closing the sink is the caller's job)."""
        if self.profiler is not None:
            self.profiler.close()

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

    def _sample(self, last: Tensor, mets):
        """Next token per row of `last` (n, vocab), greedy or through the
        engine's generator, and the step's metrics, on the host."""
        if self.temperature > 0.0 and self.mesh is not None:
            import torch.distributed as dist

            # rank 0 draws, every rank takes its ids: one stream of draws
            if dist.get_rank() == 0:
                nxt = torch.multinomial(torch.softmax(last / self.temperature, dim=-1), 1,
                                        generator=self._gen)[:, 0]
            else:
                nxt = torch.empty((last.shape[0],), dtype=torch.int64, device=last.device)
            dist.broadcast(nxt, src=0)
        elif self.temperature > 0.0:
            probs = torch.softmax(last / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt.cpu().numpy(), {k: v.cpu().numpy() for k, v in mets.items()}

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
        return self._sample(logits[torch.arange(logits.shape[0], device=dev), idx], mets)

    @torch.no_grad()
    def _serve_step_packed(self, tokens, positions, segments, write_slots, cache_rows,
                           gather_rows, gather_cols):
        """One model step in the packed layout (operands from
        `_plan_packed`, sent to the device in one copy); each SLOT samples
        at (gather_rows, gather_cols), its last real column in the grid."""
        arrays = (tokens, positions, segments, write_slots, cache_rows, gather_rows, gather_cols)
        flat = torch.from_numpy(np.concatenate([np.ravel(a) for a in arrays]).astype(np.int64))
        dev_flat = flat.to(self.device)
        (tok, pos, seg, ws, rows, g_rows, g_cols) = (
            t.view(a.shape) for t, a in zip(dev_flat.split([a.size for a in arrays]), arrays)
        )
        logits, self.cache, self.router_states, mets = self.model.prefill_chunk(
            self.params, tok, self.cache, self.router_states,
            positions=pos, segments=seg, write_slots=ws, cache_rows=rows,
        )
        return self._sample(logits[g_rows, g_cols], mets)

    def _plan_packed(self, active):
        """Packed-layout step plan (the reference engine's planner), or None
        when the one-row-per-slot layout is already step-optimal.

        Packing pays only when some prompt has more than `chunk_size` tokens
        left: its next chunks then SPREAD across rows that would otherwise
        idle (all-global stacks only), finishing a k-chunk prefill in
        ceil(k / n_free_rows) steps instead of k. Short fresh prompts are
        tucked into used rows' free columns as extra segments, vacating
        their rows for spreading. Returns the operand arrays of
        `_serve_step_packed` plus the bookkeeping plan; None whenever no
        row would spread, so steady-state decode keeps the one-row step."""
        b, c = self.n_slots, self.chunk_size
        if not self._can_spread:
            return None
        if not any(
            not slot.prompt_done and len(slot.request.prompt) - slot.n_prefilled > c
            for _, slot in active
        ):
            return None

        tokens = np.zeros((b, c), np.int64)
        positions = np.zeros((b, c), np.int64)
        segments = np.full((b, c), -1, np.int64)
        write_slots = np.full((b, c), -1, np.int64)
        cache_rows = np.arange(b, dtype=np.int64)
        gather_rows = np.zeros((b,), np.int64)
        gather_cols = np.zeros((b,), np.int64)
        col_used = np.zeros((b,), np.int64)
        next_seg = np.ones((b,), np.int64)
        row_taken = [False] * b
        plan: List[tuple] = []

        decodes, shorts, streams = [], [], []
        for i, slot in active:
            if slot.prompt_done:
                decodes.append((i, slot))
            elif slot.n_prefilled == 0 and len(slot.request.prompt) < c:
                shorts.append((i, slot))
            else:
                streams.append((i, slot))

        for i, slot in decodes:
            tokens[i, 0] = slot.request.output[-1]
            positions[i, 0] = slot.pos - 1  # == cache pos of slot i
            segments[i, 0] = 0
            write_slots[i, 0] = i
            col_used[i] = 1
            row_taken[i] = True
            gather_rows[i], gather_cols[i] = i, 0
            plan.append((i, slot, DECODE, 1))

        # prefill streams: first chunk in the slot's own row as the resident
        # (segment 0) continuation of its cache
        rem: Dict[int, int] = {}
        last_at: Dict[int, tuple] = {}
        stream_slot = dict(streams)
        for i, slot in streams:
            p0 = slot.n_prefilled
            n = min(len(slot.request.prompt) - p0, c)
            tokens[i, :n] = slot.request.prompt[p0 : p0 + n]
            positions[i, :n] = np.arange(p0, p0 + n)
            segments[i, :n] = 0
            write_slots[i, :n] = i
            col_used[i] = n
            row_taken[i] = True
            rem[i] = len(slot.request.prompt) - p0 - n
            last_at[i] = (i, n - 1, n)  # (row, col, placed so far)

        # short fresh prompts: best fit into a used row's padding columns as
        # a fresh segment (frees their own row for spreading below)
        for i, slot in sorted(shorts, key=lambda t: -len(t[1].request.prompt)):
            n = len(slot.request.prompt)
            fit = [r for r in range(b) if row_taken[r] and col_used[r] + n <= c]
            r = min(fit, key=lambda r: c - col_used[r] - n) if fit else i
            s = int(next_seg[r])
            row_taken[r] = True
            lo = col_used[r]
            tokens[r, lo : lo + n] = slot.request.prompt
            positions[r, lo : lo + n] = np.arange(n)
            segments[r, lo : lo + n] = s
            write_slots[r, lo : lo + n] = i
            next_seg[r] = s + 1
            col_used[r] = lo + n
            gather_rows[i], gather_cols[i] = r, lo + n - 1
            plan.append((i, slot, PREFILL, n))

        # spread: hand free rows to the streams with the most prompt left
        used_extra = False
        for r in [r for r in range(b) if not row_taken[r]]:
            if not rem:
                break
            i = max(rem, key=rem.get)
            if rem[i] <= 0:
                break
            slot = stream_slot[i]
            p0 = slot.n_prefilled + last_at[i][2]
            n = min(rem[i], c)
            tokens[r, :n] = slot.request.prompt[p0 : p0 + n]
            positions[r, :n] = np.arange(p0, p0 + n)
            segments[r, :n] = 0
            cache_rows[r] = i  # this row CONTINUES slot i's stream
            write_slots[r, :n] = i
            col_used[r] = n
            row_taken[r] = True
            rem[i] -= n
            last_at[i] = (r, n - 1, last_at[i][2] + n)
            used_extra = True

        if not used_extra:
            return None  # nothing spread: the one-row layout is the same
        for i, slot in streams:
            r, col, placed = last_at[i]
            gather_rows[i], gather_cols[i] = r, col
            plan.append((i, slot, PREFILL, placed))
        return (
            tokens, positions, segments, write_slots, cache_rows,
            gather_rows, gather_cols, plan,
        )

    def step(self) -> List[Request]:
        """One fused serve step. Returns requests completed this step —
        including any dropped by the deadline/timeout sweep or shed at
        submit, so every request's outcome is reported exactly once."""
        if self.step_delay > 0:
            time.sleep(self.step_delay)  # slow_step fault injection
        if self.profiler is not None:
            self.profiler.step(self.telemetry.n_steps)
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

        packed = self._plan_packed(active) if self._can_pack else None
        if packed is not None:
            *operands, plan = packed
            with trace_span("serve/step"):
                nxt, mets = self._serve_step_packed(*operands)
        else:
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
            with trace_span("serve/step"):
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


# ----------------------------------------------------------- compatibility


def greedy_generate(
    model: Model,
    params,
    prompts,
    n_steps: int,
    max_seq_len: int = 2048,
    extra_batch: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Batched greedy decoding of `prompts` (B, S) (an array or a tensor)
    for n_steps tokens each; returns the (B, n_steps) int64 tokens on the
    CPU. Token families go
    through the continuous-batching engine; encdec and vlm models, and any
    call with `extra_batch` side inputs, take the per-token path."""
    cfg = model.cfg
    prompts = torch.as_tensor(prompts).to("cpu", torch.int64)
    if extra_batch or cfg.n_enc_layers or cfg.frontend_dim:
        return _legacy_generate(model, params, prompts, n_steps, max_seq_len, extra_batch)
    b, s = prompts.shape
    eng = ContinuousBatchingEngine(
        model,
        params,
        n_slots=b,
        chunk_size=min(max(s, 1), 64),
        # honour the (B, n_steps) contract: never evict on 'length'
        max_seq_len=max(max_seq_len, s + n_steps + 1),
    )
    reqs = [eng.submit(prompts[i].numpy(), n_steps, ignore_eos=True) for i in range(b)]
    if any(r is None for r in reqs):
        raise RuntimeError("the engine refused a request")
    eng.run()
    return torch.tensor([r.output for r in reqs], dtype=torch.int64)


@torch.no_grad()
def _legacy_generate(model: Model, params, prompts, n_steps, max_seq_len, extra_batch):
    """Per-token prefill then greedy decode against `Model.init_cache`
    (the encoder runs once; the vlm prefix is not seen, as in the
    reference's serving path)."""
    dev = model.device
    batch = {"tokens": prompts.to(dev)}
    for k, v in (extra_batch or {}).items():
        batch[k] = (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(dev)
    cache = model.init_cache(params, batch, max_seq_len)
    states = model.init_router_states()
    tokens = batch["tokens"]
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache, states = model.decode_step(params, tokens[:, t : t + 1], cache, states)
    out = []
    for _ in range(n_steps):
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        out.append(nxt)
        logits, cache, states = model.decode_step(params, nxt, cache, states)
    return torch.cat(out, dim=1).cpu()
