#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc (sm_90a) and time the build;
  2. each kernel against its plain PyTorch version at the serving shape
     (E=16, C=160, D=512, F=1408) and a ragged one (C=37, F=1400), in bf16
     and fp32, with the stated tolerance; kernel, plain-version and library
     (torch.bmm) times beside the bound the card could reach;
  3. a small-input reference check of one full-width MoE layer (kernel path
     against the plain einsum path on the same routing);
  4. serve minimind-moe-16e at full width (seeded random weights) through the
     continuous-batching engine with use_kernel=True: 32 requests, prompts of
     16-96 tokens, 32 greedy tokens each; the kernels' launch counts from
     this run must be > 0;
  5. a short torch.profiler trace of serve steps: device busy share, kernel
     launches per step, the kernels that take the most device time.
The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}. It needs no network and starts no process
that outlives it (nvcc and nvidia-smi run to completion).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (dense): bf16 tensor cores, fp32 without them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SMOKE = (16, 160, 512, 1408)  # (E, C, D, F): minimind-16e at 16 slots x 32 tokens
RAGGED = (16, 37, 512, 1400)
TOL = {  # |kernel - plain| <= rtol*|plain| + atol_frac*max|plain|
    # bf16 output: the fp32 sums differ in order, so one rounding to bf16
    # (2^-7 relative) may land on the other neighbour
    "bfloat16": (2.0**-6, 2.0**-8),
    "float32": (1e-5, 1e-6),
}


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, arg_sets, reps=10):
    """Mean device time of one call, by CUDA events over reps x len(arg_sets)
    calls. Cycling through several weight sets (one per layer) keeps the
    weights cold in L2, as the serving path finds them."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in arg_sets:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def bound(name, shape, dtype):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and FLOPs / peak,
    counting each input read once and each output written once."""
    e, c, d, f = shape
    size = 2 if dtype == "bfloat16" else 4
    if name == "grouped_gated_ffn_in":
        elems = e * c * d + 2 * e * d * f + e * c * f
        flops = 2 * 2 * e * c * d * f
    else:
        elems = e * c * f + e * f * d + e * c * d
        flops = 2 * e * c * f * d
    t_bytes = elems * size / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, moe_gemm, shape, dtype_name, gen):
    """Kernel vs plain version on one shape/dtype; returns the max abs errors."""
    dt = getattr(torch, dtype_name)
    e, c, d, f = shape
    x = torch.randn(e, c, d, device="cuda", generator=gen).to(dt)
    wg = (torch.randn(e, d, f, device="cuda", generator=gen) / d**0.5).to(dt)
    wu = (torch.randn(e, d, f, device="cuda", generator=gen) / d**0.5).to(dt)
    wd = (torch.randn(e, f, d, device="cuda", generator=gen) / f**0.5).to(dt)
    h = moe_gemm.grouped_gated_ffn_in(x, wg, wu)
    y = moe_gemm.grouped_matmul(h, wd)
    h_ref = moe_gemm.grouped_gated_ffn_in_plain(x, wg, wu)
    y_ref = moe_gemm.grouped_matmul_plain(h, wd)  # same input h: K2 alone
    torch.cuda.synchronize()
    rtol, atol_frac = TOL[dtype_name]
    out = {}
    for name, got, want in (("grouped_gated_ffn_in", h, h_ref), ("grouped_matmul", y, y_ref)):
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {dtype_name} {shape}: non-finite output")
        err = (got - want).abs()
        limit = rtol * want.abs() + atol_frac * want.abs().max()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp_min(1e-3 * float(want.abs().max()))).max())
        ok = bool((err <= limit).all())
        print(f"  {name:22s} {dtype_name:8s} E,C,D,F={shape}: max_abs_err {max_abs:.3e} "
              f"max_rel_err {max_rel:.3e} (tolerance rtol {rtol:.2e} + {atol_frac:.2e}*max|ref|) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {dtype_name} {shape} disagrees with its plain version")
        out[name] = max_abs
    return out


def profile_steps(torch, eng, vocab, rng, n_requests=16, prompt=32, gen=8):
    """Trace a short serve run (one prefill step, then decode steps) with
    torch.profiler: device busy share of the wall time, kernel launches per
    step, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(n_requests):
        eng.submit(rng.integers(0, vocab, (prompt,)), gen, ignore_eos=True)
    eng.step()  # admission + first prefill outside the trace
    torch.cuda.synchronize()
    n_steps = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while eng.scheduler.has_work:
            eng.step()
            n_steps += 1
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("[profile] the profiler recorded no device activity: busy share not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"[profile] {n_steps} decode steps ({n_requests} slots busy): wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms = {100 * busy_us / wall_us:.1f}% "
          f"(idle {100 - 100 * busy_us / wall_us:.1f}%), "
          f"{len(kernels) / max(n_steps, 1):.0f} kernel launches per step")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / busy_us:6.1%} of device time  {t / 1e3:8.3f} ms  {n:6d} launches  {name[:90]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import moe_gemm
    from repro_torch.models import Model, moe
    from repro_torch.serving import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    print("fp32 matmuls in full fp32: torch.backends.cuda.matmul.allow_tf32 = False")

    # -- 1. build
    t0 = time.perf_counter()
    moe_gemm.build()
    print(f"[build] nvcc sm_90a moe_gemm.cu: {time.perf_counter() - t0:.2f} s")

    # -- 2. kernels against their plain versions, and their times
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("[kernels] kernel vs plain PyTorch version")
    err = {}
    for shape in (SMOKE, RAGGED):
        for dtype_name in ("bfloat16", "float32"):
            errs = check_kernels(torch, moe_gemm, shape, dtype_name, gen)
            if shape == SMOKE and dtype_name == "bfloat16":
                err = errs
    e_, c_, d_, f_ = SMOKE
    layers = []  # one weight set per layer of the model, so L2 stays cold
    for _ in range(8):
        x = torch.randn(e_, c_, d_, device="cuda", generator=gen).bfloat16()
        wg = (torch.randn(e_, d_, f_, device="cuda", generator=gen) / d_**0.5).bfloat16()
        wu = (torch.randn(e_, d_, f_, device="cuda", generator=gen) / d_**0.5).bfloat16()
        wd = (torch.randn(e_, f_, d_, device="cuda", generator=gen) / f_**0.5).bfloat16()
        h = moe_gemm.grouped_gated_ffn_in_plain(x, wg, wu)
        layers.append((x, wg, wu, wd, h, torch.cat([wg, wu], dim=-1)))
    timings = {
        "grouped_gated_ffn_in": (
            time_ms(torch, moe_gemm.grouped_gated_ffn_in, [l[:3] for l in layers]),
            time_ms(torch, moe_gemm.grouped_gated_ffn_in_plain, [l[:3] for l in layers]),
            # one bmm over [wg | wu]: both products, without the SwiGLU epilogue
            time_ms(torch, torch.bmm, [(l[0], l[5]) for l in layers]),
        ),
        "grouped_matmul": (
            time_ms(torch, moe_gemm.grouped_matmul, [(l[4], l[3]) for l in layers]),
            time_ms(torch, moe_gemm.grouped_matmul_plain, [(l[4], l[3]) for l in layers]),
            time_ms(torch, torch.bmm, [(l[4], l[3]) for l in layers]),
        ),
    }
    w32 = [(l[1].float(), l[2].float(), l[3].float()) for l in layers]
    cast_ms = time_ms(torch, lambda a, b, c: (a.bfloat16(), b.bfloat16(), c.bfloat16()), w32)
    for name, (k_ms, p_ms, lib_ms) in timings.items():
        b_ms, b_by = bound(name, SMOKE, "bfloat16")
        print(f"  {name:22s} bf16 E,C,D,F={SMOKE}: kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
              f"library_ms (torch.bmm) {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    print(f"  per-call fp32->bf16 cast of one layer's expert weights: {cast_ms:.4f} ms")
    del layers, w32

    # -- 3. one full-width MoE layer: kernel path vs plain einsum path
    cfg = configs.get("minimind_moe_16e")
    n_slots, chunk = 16, 32
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    lp = params["stack"]["layers"][0]["moe"]
    n = n_slots * chunk
    xin = torch.randn(n, cfg.d_model, device="cuda", generator=gen).bfloat16()
    mask = torch.rand(n, device="cuda", generator=gen) < 0.5
    xin = xin * mask[:, None].to(xin.dtype)
    state = model.init_router_states()[0]
    outs = {}
    for use_kernel in (True, False):
        c2 = dataclasses.replace(cfg, routing=dataclasses.replace(cfg.routing, use_kernel=use_kernel))
        with torch.no_grad():
            outs[use_kernel] = moe.moe_ffn_local(lp, xin, state, c2, token_mask=mask)
    (yk, sk, _, mk), (yp, sp, _, mp) = outs[True], outs[False]
    if not bool(torch.equal(mk["load"], mp["load"])) or not bool(torch.equal(sk["q"], sp["q"])):
        raise AssertionError("MoE layer: routing differs between the kernel and plain paths")
    yk, yp = yk.float()[mask], yp.float()[mask]
    rel = float((yk - yp).norm() / yp.norm())
    print(f"[reference] full-width MoE layer, kernel vs plain einsum path: relative error {rel:.3e} "
          f"(tolerance 1e-2, bf16); routing identical; finite {bool(torch.isfinite(yk).all())}")
    if not (rel < 1e-2 and bool(torch.isfinite(yk).all())):
        raise AssertionError("MoE layer: kernel path disagrees with the plain path")

    # -- 4. serve minimind-moe-16e at full width through the port's engine
    rng = np.random.default_rng(0)
    gen_len, max_prompt = 32, 96
    eng = ContinuousBatchingEngine(
        model, params, n_slots=n_slots, chunk_size=chunk,
        max_seq_len=max_prompt + gen_len + 1, use_kernel=True,
    )
    for _ in range(2):  # warm-up requests, outside the measured run
        eng.submit(rng.integers(0, cfg.vocab_size, (40,)), 4, ignore_eos=True)
    eng.run()
    eng.telemetry.reset()
    reqs = []
    for _ in range(32):
        plen = int(rng.integers(16, max_prompt + 1))
        reqs.append(eng.submit(rng.integers(0, cfg.vocab_size, (plen,)), gen_len, ignore_eos=True))
    if any(r is None for r in reqs):
        raise AssertionError("engine refused a request")
    moe_gemm.reset_launch_counts()  # count only the main path's launches
    step_s = []
    t_run = time.perf_counter()
    while eng.scheduler.has_work:
        ts = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t_run
    launches = {
        "grouped_gated_ffn_in": moe_gemm.grouped_gated_ffn_in.launches,
        "grouped_matmul": moe_gemm.grouped_matmul.launches,
    }
    for r in reqs:
        if r.finish_reason != "max_new_tokens" or len(r.output) != gen_len:
            raise AssertionError(f"request {r.req_id} ended {r.finish_reason} with {len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.req_id} produced an out-of-vocabulary token")
    tokens = eng.prefill_tokens + eng.decode_tokens
    load = eng.expert_load
    st = sorted(step_s)
    p50 = 1e3 * st[len(st) // 2]
    p99 = 1e3 * st[min(len(st) - 1, int(round(0.99 * (len(st) - 1))))]
    print(f"[serve] minimind-moe-16e full width (8 layers, d 512, 16 experts top-4, vocab 6400), "
          f"bf16 compute, {n_slots} slots x chunk {chunk}, {len(reqs)} requests, prompts 16-{max_prompt}, "
          f"{gen_len} greedy tokens each")
    print(f"  steps {eng.n_steps}, prefill tokens {eng.prefill_tokens}, decode tokens {eng.decode_tokens}, "
          f"wall {wall:.3f} s, tokens/s {tokens / wall:.1f}, step p50 {p50:.2f} ms, p99 {p99:.2f} ms")
    print(f"  per-expert load {load.astype(int).tolist()} MaxVio {eng.telemetry.live_max_vio():.4f} "
          f"(mean per-step max-layer MaxVio {sum(eng.max_vio_per_step) / len(eng.max_vio_per_step):.4f})")
    print(f"  kernel launches in this run: {launches} "
          f"(= {cfg.n_layers} MoE layers x {eng.n_steps} steps = {cfg.n_layers * eng.n_steps})")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was never launched on the main path")

    # -- 5. where a serve step's time goes (a short traced run, after the
    # launch counts above were read)
    profile_steps(torch, eng, cfg.vocab_size, rng)

    cap = moe.expert_capacity(n_slots * chunk, cfg)
    shape = (cfg.routing.n_experts, cap, cfg.d_model, cfg.moe_d_ff)
    record = []
    for name, line in (("grouped_gated_ffn_in", 41), ("grouped_matmul", 94)):
        k_ms, p_ms, lib_ms = timings[name]
        b_ms, b_by = bound(name, shape, "bfloat16")
        record.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
            "replaces": f"src/repro/kernels/moe_gemm.py:{line}",
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
        })
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
