"""The port on the GPU: the CUDA kernels against their plain versions, the
serving engine and the train step launching them, the prefetcher's copies
to the card, the checkpoint's on-device snapshot, and the phi / lpr /
expert_choice balancers (expert-choice's sentinel slots included), the
training telemetry ring and profiler window, and the other families'
pieces (the chunked SSD, K1/K2 at llama4-scout's serving shape, a served
zamba2), the packed multi-request prefill through K1/K2, and K4 (the fused
causal attention) against its plain version and on the training step.
Needs an NVIDIA GPU and nvcc; skips elsewhere. Imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data import make_batches  # noqa: E402
from repro_torch.kernels import bip_admm, flash_attn, moe_gemm, ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import constant, from_model_config  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(2, 5, 40, 24), (3, 37, 72, 200), (16, 160, 512, 1408)]  # (E, C, D, F)
# the bf16 GEMM's cases besides SHAPES: a decode step (C=1), ragged C with
# D and F that are not multiples of 64 (K of K1 and of K2), the training shape
LAYOUT_SHAPES = SHAPES + [(4, 1, 512, 1408), (2, 136, 200, 264), (16, 2560, 512, 1408)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dt, dev, seed=0):
    e, c, d, f = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(e, c, d, device=dev, generator=g).to(dt)
    wg = (torch.randn(e, d, f, device=dev, generator=g) / d**0.5).to(dt)
    wu = (torch.randn(e, d, f, device=dev, generator=g) / d**0.5).to(dt)
    wd = (torch.randn(e, f, d, device=dev, generator=g) / f**0.5).to(dt)
    return x, wg, wu, wd


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain(cuda_device, shape, dtype, monkeypatch):
    dt = getattr(torch, dtype)
    x, wg, wu, wd = _inputs(shape, dt, cuda_device)
    plain_in, plain_mm = moe_gemm.grouped_gated_ffn_in_plain, moe_gemm.grouped_matmul_plain

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor must not take the plain version")

    monkeypatch.setattr(moe_gemm, "grouped_gated_ffn_in_plain", forbidden)
    monkeypatch.setattr(moe_gemm, "grouped_matmul_plain", forbidden)
    moe_gemm.reset_launch_counts()
    h = moe_gemm.grouped_gated_ffn_in(x, wg, wu)
    y = moe_gemm.grouped_matmul(h, wd)
    torch.cuda.synchronize()
    assert moe_gemm.grouped_gated_ffn_in.launches == 1
    assert moe_gemm.grouped_matmul.launches == 1
    # bf16 outputs may differ by one rounding of the fp32 sum (2^-7 relative)
    rtol, atol = (1e-5, 1e-6) if dt == torch.float32 else (2.0**-6, 2.0**-8)
    hp, yp = plain_in(x, wg, wu), plain_mm(h, wd)
    torch.testing.assert_close(h.float(), hp.float(), rtol=rtol, atol=atol * hp.abs().max().item())
    torch.testing.assert_close(y.float(), yp.float(), rtol=rtol, atol=atol * yp.abs().max().item())


def _with_layout(t, k_axis, major):
    """t's values with the unit stride on the reduction axis k_axis ('K')
    or on the other matrix axis ('MN')."""
    unit = k_axis if major == "K" else 3 - k_axis
    return t if t.stride(unit) == 1 else t.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("a_major", ["K", "MN"])
@pytest.mark.parametrize("b_major", ["K", "MN"])
def test_bf16_layout_pairs_match_plain(cuda_device, shape, kernel, a_major, b_major):
    """The TMA + wgmma kernel reads each operand as it lies, K-major or
    MN-major: every (A, B) pair of K1 and K2 agrees with the plain version
    within one bf16 rounding of the fp32 sum (rtol 2^-6 + 2^-8 max|ref|).
    An MN-major A at a C that is not a multiple of 8 puts a stride of C
    elements on K, which TMA cannot read: it raises ValueError instead."""
    x, wg, wu, wd = _inputs(shape, torch.bfloat16, cuda_device, seed=3)
    if kernel == "K1":
        a, bs = _with_layout(x, 2, a_major), [_with_layout(w, 1, b_major) for w in (wg, wu)]
        fn, plain = moe_gemm.grouped_gated_ffn_in, moe_gemm.grouped_gated_ffn_in_plain
    else:
        h = moe_gemm.grouped_gated_ffn_in_plain(x, wg, wu)
        a, bs = _with_layout(h, 2, a_major), [_with_layout(wd, 1, b_major)]
        fn, plain = moe_gemm.grouped_matmul, moe_gemm.grouped_matmul_plain
    moe_gemm.reset_launch_counts()
    if a_major == "MN" and shape[1] > 1 and shape[1] % 8:
        with pytest.raises(ValueError, match="TMA"):
            fn(a, *bs)
        assert moe_gemm.grouped_gated_ffn_in.launches + moe_gemm.grouped_matmul.launches == 0
        return
    if shape[1] > 1:  # C=1 leaves size-1 axes, which may count either way
        assert moe_gemm.tma_layout(a, bs[0])[0] == (a_major, b_major)
    got = fn(a, *bs)
    torch.cuda.synchronize()
    assert moe_gemm.grouped_gated_ffn_in.launches + moe_gemm.grouped_matmul.launches == 1
    want = plain(a, *bs).float()
    torch.testing.assert_close(got.float(), want, rtol=2.0**-6, atol=2.0**-8 * want.abs().max().item())


@pytest.mark.parametrize("case", ["misaligned_base", "row_stride_24_bytes"])
def test_bf16_refuses_what_tma_cannot_read(cuda_device, case):
    """A bf16 CUDA operand that TMA cannot describe raises ValueError before
    any launch: a base off the 16-byte grain, a row stride of 24 bytes."""
    x, wg, wu, wd = _inputs((2, 8, 16, 24), torch.bfloat16, cuda_device)
    if case == "misaligned_base":
        x = torch.zeros(2 * 8 * 16 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(2, 8, 16)
    else:
        x = torch.zeros(2, 8, 12, dtype=torch.bfloat16, device=cuda_device)[:, :, :10]
        wg, wu = wg[:, :10], wu[:, :10]
    moe_gemm.reset_launch_counts()
    with pytest.raises(ValueError, match="TMA|16-byte"):
        moe_gemm.grouped_gated_ffn_in(x, wg, wu)
    w = torch.zeros(2, x.shape[2], 8, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="TMA|16-byte"):
        moe_gemm.grouped_matmul(x, w)
    assert moe_gemm.grouped_gated_ffn_in.launches == moe_gemm.grouped_matmul.launches == 0


def test_bf16_launch_from_a_thread_without_a_context(cuda_device):
    """A thread whose first CUDA work is the bf16 kernel (autograd's device
    thread when the backward starts with K2) has no current context yet;
    the tensor maps must still encode and the product agree."""
    x, wg, wu, wd = _inputs((2, 40, 64, 96), torch.bfloat16, cuda_device, seed=7)
    out = {}

    def run():
        try:
            out["y"] = moe_gemm.grouped_matmul(x, wg)
            torch.cuda.synchronize()
        except Exception as exc:  # reported by the assertion below
            out["error"] = exc

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and "error" not in out, out.get("error")
    want = moe_gemm.grouped_matmul_plain(x, wg).float()
    torch.testing.assert_close(out["y"].float(), want, rtol=2.0**-6, atol=2.0**-8 * want.abs().max().item())


def test_engine_serves_through_the_kernels(cuda_device):
    full = configs.get("minimind_moe_16e")
    cfg = configs.reduced_for_smoke("minimind_moe_16e", routing=full.routing, vocab_size=128)
    model = Model(cfg)  # the default device is the GPU
    assert model.device.type == "cuda"
    eng = ContinuousBatchingEngine(
        model, model.init(0), n_slots=4, chunk_size=8, max_seq_len=40, use_kernel=True
    )
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, 128, (int(rng.integers(3, 20)),)), 6, ignore_eos=True)
            for _ in range(6)]
    moe_gemm.reset_launch_counts()
    eng.run()
    assert all(len(r.output) == 6 and all(0 <= t < 128 for t in r.output) for r in reqs)
    launches = cfg.n_layers * eng.n_steps
    assert moe_gemm.grouped_gated_ffn_in.launches == launches
    assert moe_gemm.grouped_matmul.launches == launches


@pytest.mark.parametrize("n,m,k", [(8192, 16, 4), (1000, 64, 8), (1001, 16, 4), (4096, 128, 2)])
@pytest.mark.parametrize("refined", [False, True])
def test_admm_kernel_is_bit_equal_to_plain(cuda_device, n, m, k, refined):
    """K3's single-pass mode (the Pallas function's contract): p and counts
    equal to the plain version's, bit for bit (exact order statistic,
    integer counts, the same edges), in one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(n + m)
    s = torch.softmax(torch.randn(n, m, device=cuda_device, generator=g) * 2, dim=-1)
    q = torch.rand(m, device=cuda_device, generator=g) * 0.3
    lo = -torch.ones(m, device=cuda_device)
    hi = torch.ones(m, device=cuda_device)
    if refined:
        _, cnt = bip_admm.bip_admm_iteration_plain(s, q, lo, hi, top_k=k, n_bins=512)
        lo, hi, _ = bip_admm.locate_bin(cnt, n * k // m, 512, lo, hi)
    bip_admm.reset_launch_counts()
    p, cnt = bip_admm.bip_admm_iteration(s, q, top_k=k, lo=lo, hi=hi)
    torch.cuda.synchronize()
    assert bip_admm.bip_admm_iteration.launches == 1
    pp, cp = bip_admm.bip_admm_iteration_plain(s, q, lo, hi, top_k=k, n_bins=512)
    assert torch.equal(p, pp) and torch.equal(cnt, cp)


# (n, m, k, T): minimind-moe-16e's training shape, a ragged n, 64e's own
# shape and T, a short one at m = 64, arctic's m = 128, a k past the
# register list (p by distinct-value sweeps), and llama4-scout's training
# router (2 x 2048 tokens, top-1)
DUAL_CASES = [(8192, 16, 4, 4), (8191, 16, 4, 4), (8192, 64, 8, 14), (1000, 64, 8, 4),
              (4096, 128, 2, 4), (512, 16, 12, 3), (4096, 16, 1, 4)]


def _dual_inputs(dev, n, m, warm, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + n + m)
    s = torch.softmax(torch.randn(n, m, device=dev, generator=g) * 2, dim=-1)
    q0 = torch.rand(m, device=dev, generator=g) * 0.3 if warm else torch.zeros(m, device=dev)
    return s, q0


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("n,m,k,t", DUAL_CASES)
def test_fused_dual_update_is_bit_equal_to_plain(cuda_device, n, m, k, t, refine, warm, monkeypatch):
    """K3's fused update: one launch per call, and q equal to the plain
    torch loop's bit for bit (torch.equal), cold or warm-started, with 0-2
    refine passes."""
    s, q0 = _dual_inputs(cuda_device, n, m, warm)
    plain = bip_admm.bip_dual_update_plain

    def forbidden(*a, **kw):
        raise AssertionError("a CUDA tensor must not take the plain loop")

    monkeypatch.setattr(bip_admm, "bip_dual_update_plain", forbidden)
    bip_admm.reset_launch_counts()
    q = ops.bip_dual_update(s, q0, top_k=k, n_iters=t, refine=refine)
    torch.cuda.synchronize()
    assert bip_admm.bip_dual_update.launches == 1
    assert bip_admm.bip_admm_iteration.launches == 0
    assert torch.equal(q, plain(s, q0, top_k=k, n_iters=t, refine=refine))


def test_fused_dual_update_on_a_cluster_of_8(cuda_device, monkeypatch):
    """Where a cluster of 16 cannot be placed the wrapper launches 8 CTAs
    (the portable size): same q, bit for bit."""
    n, m, k, t = 8192, 64, 8, 14
    s, q0 = _dual_inputs(cuda_device, n, m, True)
    plan16 = bip_admm.launch_plan(n, m, 512, 16)
    index = torch.cuda.current_device()
    monkeypatch.setitem(bip_admm._placeable, (index, 16, plan16.smem_bytes), False)
    assert bip_admm.device_plan(n, m, 512, cuda_device).cluster == 8
    q = ops.bip_dual_update(s, q0, top_k=k, n_iters=t)
    assert torch.equal(q, bip_admm.bip_dual_update_plain(s, q0, top_k=k, n_iters=t))


def test_fused_dual_update_from_a_fresh_thread(cuda_device):
    """A thread whose first CUDA work is the fused update (autograd's or a
    server's worker) launches it once and gets the plain loop's q."""
    s, q0 = _dual_inputs(cuda_device, 8192, 16, True, seed=5)
    out = {}

    def run():
        try:
            out["q"] = ops.bip_dual_update(s, q0, top_k=4, n_iters=4)
            torch.cuda.synchronize()
        except Exception as exc:  # reported by the assertion below
            out["error"] = exc

    bip_admm.reset_launch_counts()
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and "error" not in out, out.get("error")
    assert bip_admm.bip_dual_update.launches == 1
    assert torch.equal(out["q"], bip_admm.bip_dual_update_plain(s, q0, top_k=4, n_iters=4))


def test_fused_dual_update_refusals(cuda_device):
    """Capacity slack returns zeros with no launch; what the kernel refuses
    (n_bins off a power of two, more expert histograms than a CTA's shared
    memory holds) raises, with no fallback to the plain loop."""
    bip_admm.reset_launch_counts()
    s, q0 = _dual_inputs(cuda_device, 64, 4, True)
    assert torch.equal(ops.bip_dual_update(s, q0, top_k=4, n_iters=4), torch.zeros_like(q0))
    s, q0 = _dual_inputs(cuda_device, 1024, 16, False)
    with pytest.raises(ValueError, match="power of two"):
        ops.bip_dual_update(s, q0, top_k=4, n_iters=4, n_bins=500)
    s, q0 = _dual_inputs(cuda_device, 1024, 4096, False)
    with pytest.raises(ValueError, match="shared"):
        ops.bip_dual_update(s, q0, top_k=4, n_iters=4)
    assert bip_admm.bip_dual_update.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_backward_through_kernels(cuda_device, dtype):
    """The backward's eight K2 launches give the gradients that the same
    backward on the plain versions gives: fp32 elementwise 1e-5 relative;
    bf16 within 2^-6 in norm (each product rounds once to bf16, and the
    intermediates' one-rounding differences carry on)."""
    dt = getattr(torch, dtype)
    x, wg, wu, wd = _inputs((3, 37, 72, 200), dt, cuda_device, seed=1)
    dy = torch.randn(x.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(2)).to(dt)

    def grads():
        leaves = [a.detach().clone().requires_grad_(True) for a in (x, wg, wu, wd)]
        ops.expert_ffn(*leaves).backward(dy)
        return [a.grad.float() for a in leaves]

    moe_gemm.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    assert moe_gemm.grouped_matmul.launches == 1 + 8
    assert moe_gemm.grouped_gated_ffn_in.launches == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_gemm, "grouped_gated_ffn_in", moe_gemm.grouped_gated_ffn_in_plain)
        mp.setattr(moe_gemm, "grouped_matmul", moe_gemm.grouped_matmul_plain)
        want = grads()
    for a, b in zip(got, want):
        if dt == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * b.abs().max().item())
        else:
            assert float((a - b).norm() / b.norm()) <= 2.0**-6


def test_backward_uses_at_capacity_320(cuda_device):
    """K2's eight backward uses over the views the expert-FFN backward
    passes, at llama4-scout's training capacity C = 320 (E, D, F cut to 4,
    256, 512): TMA takes every operand (C's stride of 320 bf16 elements is
    on its 16-byte grain), each product is one bf16 rounding of its plain
    version, and the gradients match the backward on the plain versions
    within 2^-6 in norm."""
    x, wg, wu, wd = _inputs((4, 320, 256, 512), torch.bfloat16, cuda_device, seed=3)
    dy = torch.randn(x.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(4)).bfloat16()
    t = lambda a: a.transpose(-1, -2)  # noqa: E731
    mm = moe_gemm.grouped_matmul_plain
    g, u = mm(x, wg), mm(x, wu)
    h = (torch.nn.functional.silu(g.float()) * u.float()).bfloat16()
    dh = mm(dy, t(wd))
    products = {"g": (x, wg), "u": (x, wu), "dh": (dy, t(wd)), "dwd": (t(h), dy), "dx_g": (dh, t(wg)),
                "dx_u": (dh, t(wu)), "dwg": (t(x), dh), "dwu": (t(x), g)}
    pairs = set()
    for name, (a, b) in products.items():
        pairs.add(moe_gemm.tma_layout(a, b)[0])
        got, want = moe_gemm.grouped_matmul(a, b).float(), mm(a, b).float()
        torch.testing.assert_close(got, want, rtol=2.0**-6, atol=2.0**-8 * want.abs().max().item(),
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert {("K", "MN"), ("K", "K"), ("MN", "MN")} <= pairs

    def grads():
        leaves = [a.detach().clone().requires_grad_(True) for a in (x, wg, wu, wd)]
        ops.expert_ffn(*leaves).backward(dy)
        return [a.grad.float() for a in leaves]

    moe_gemm.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    assert (moe_gemm.grouped_gated_ffn_in.launches, moe_gemm.grouped_matmul.launches) == (1, 9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_gemm, "grouped_gated_ffn_in", moe_gemm.grouped_gated_ffn_in_plain)
        mp.setattr(moe_gemm, "grouped_matmul", moe_gemm.grouped_matmul_plain)
        want = grads()
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) <= 2.0**-6


def test_train_steps_launch_the_kernels(cuda_device):
    """Two reduced-width training steps (16 experts top-4, bip T=4,
    use_kernel=True): per MoE layer and step, K1 once, K2 once forward and
    eight times backward, K3 once (the whole dual update)."""
    full = configs.get("minimind_moe_16e")
    routing = dataclasses.replace(full.routing, use_kernel=True)
    cfg = configs.reduced_for_smoke("minimind_moe_16e", routing=routing, vocab_size=128)
    model = Model(cfg)
    opt = from_model_config(cfg)
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt, constant(1e-3))
    moe_gemm.reset_launch_counts()
    bip_admm.reset_launch_counts()
    losses = []
    for batch in make_batches(cfg, 4, 64, 2, device=cuda_device):
        state, mets = step(state, batch)
        losses.append(float(mets["loss"]))
    n_moe, steps = cfg.n_layers, 2
    assert moe_gemm.grouped_gated_ffn_in.launches == n_moe * steps
    assert moe_gemm.grouped_matmul.launches == n_moe * 9 * steps
    assert bip_admm.bip_dual_update.launches == n_moe * steps
    assert bip_admm.bip_admm_iteration.launches == 0
    assert all(np.isfinite(losses))
    assert float(mets["max_vio_per_layer"].max()) < 1.0


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "corpus")


def _reduced_kernel_cfg():
    full = configs.get("minimind_moe_16e")
    routing = dataclasses.replace(full.routing, use_kernel=True)
    return configs.reduced_for_smoke("minimind_moe_16e", routing=routing, vocab_size=512)


def test_prefetcher_copies_pinned_batches_on_a_side_stream(cuda_device):
    """The batches arrive on the card as int64, equal to the loader's; the
    producer stages them in pinned memory and copies them on its own
    stream; the cursor counts consumed batches only."""
    from repro_torch.data import Prefetcher, ShardedTextLoader, resolve_shards, train_tokenizer_from_files

    shards = resolve_shards(FIXTURE)
    tok = train_tokenizer_from_files(shards, vocab_size=512)

    def loader():
        return ShardedTextLoader(shards, tok, batch_size=4, seq_len=64, pack_mode="pack_nocross", seed=1)

    raw = list(itertools.islice(iter(loader()), 6))
    pf = Prefetcher(loader(), depth=2, device=cuda_device)
    got = []
    for i, batch in enumerate(iter(pf)):
        assert all(t.is_cuda and t.dtype == torch.int64 for t in batch.values())
        got.append({k: (t + 0).cpu() for k, t in batch.items()})  # read on the compute stream
        if i == 2:
            snap = pf.state_dict()
        if i == 5:
            break
    pf.close()
    for a, b in zip(raw, got):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k].numpy(), a[k])
    resumed = loader()
    resumed.load_state_dict(snap)
    np.testing.assert_array_equal(next(iter(resumed))["tokens"], raw[3]["tokens"])
    side = torch.cuda.Stream(cuda_device)
    dev, ready, pinned = pf._to_device(raw[0], side)
    assert all(t.is_pinned() for t in pinned.values())
    torch.cuda.current_stream().wait_event(ready)
    np.testing.assert_array_equal(dev["labels"].cpu().numpy(), raw[0]["labels"])


def test_async_checkpoint_snapshot_is_taken_before_the_in_place_step(cuda_device, tmp_path):
    """An async save returns after its on-device snapshot; the in-place
    AdamW step issued right after must not reach the file, which equals a
    blocking save of the same state and restores onto the card bit-equal
    to the state before that step."""
    from repro_torch.checkpoint import CheckpointManager, load_pytree
    from repro_torch.optim.adamw import tree_leaves

    cfg = _reduced_kernel_cfg()
    model = Model(cfg)
    opt = from_model_config(cfg)
    step = make_train_step(model, opt, constant(1e-3))
    b0, b1 = make_batches(cfg, 4, 64, 2, device=cuda_device)
    state, _ = step(init_train_state(model, 0, opt), b0)

    def leaves(st):
        return tree_leaves([st.params, st.opt_state["mu"], st.opt_state["nu"], st.router_states])

    before = [t.detach().clone() for t in leaves(state)]
    blocking = CheckpointManager(str(tmp_path / "b")).save_train_state(state, cfg)
    mgr = CheckpointManager(str(tmp_path / "a"))
    path = mgr.save_train_state(state, cfg, block=False)
    state, _ = step(state, b1)  # overwrites params and moments in place
    mgr.wait()
    a, b = load_pytree(path, verify=True), load_pytree(blocking, verify=True)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    rec = mgr.saves[-1]
    assert rec["snapshot_ms"] > 0 and rec["bytes"] == os.path.getsize(path)
    n, back = mgr.restore_train_state(cfg, device=cuda_device)
    assert n == 1 and back.opt_state["step"] == 1
    for x, y in zip(leaves(back), before):
        assert x.is_cuda and torch.equal(x, y)


def test_guarded_microbatched_step_on_the_card(cuda_device):
    """Two microbatches launch every kernel twice per MoE layer; a NaN step
    keeps params, moments, the step and q bit-identical."""
    from repro_torch.optim.adamw import tree_leaves

    cfg = _reduced_kernel_cfg()
    model = Model(cfg)
    opt = from_model_config(cfg)
    step = make_train_step(model, opt, constant(1e-3), microbatches=2, guarded=True)
    b0, b1 = make_batches(cfg, 4, 64, 2, device=cuda_device)
    moe_gemm.reset_launch_counts()
    bip_admm.reset_launch_counts()
    state, mets = step(init_train_state(model, 0, opt), b0, (0.0, 0.0, 1.0))
    assert bool(mets["step_ok"]) and state.opt_state["step"] == 1
    n_moe = cfg.n_layers
    assert moe_gemm.grouped_gated_ffn_in.launches == 2 * n_moe
    assert moe_gemm.grouped_matmul.launches == 2 * 9 * n_moe
    assert bip_admm.bip_dual_update.launches == 2 * n_moe
    def leaves(st):
        return tree_leaves([st.params, st.opt_state["mu"], st.opt_state["nu"], st.router_states])

    before = [t.detach().clone() for t in leaves(state)]
    state, mets = step(state, b1, (1.0, 0.0, 1.0))
    assert not bool(mets["step_ok"]) and state.opt_state["step"] == 1
    after = leaves(state)
    assert len(after) == len(before) and all(torch.equal(x, y) for x, y in zip(after, before))


# ------------------------------------------------ the other balancers


@pytest.mark.parametrize("strategy", ["phi", "lpr", "expert_choice"])
def test_new_balancers_route_on_the_card_as_on_the_cpu(cuda_device, strategy):
    """route() over 3 carried steps on CUDA tensors equals the same calls
    on the CPU: selections and counts exactly, weights and state within
    fp32 rounding (exp and matmul may round otherwise on the card)."""
    from repro_torch.core import init_router_state, route

    tc = configs.get("minimind_moe_16e").routing.to_router_config(strategy=strategy)
    sc, sg = init_router_state(tc), init_router_state(tc, cuda_device)
    rng = np.random.default_rng(11)
    for _ in range(3):
        logits = torch.from_numpy(
            (rng.standard_normal((512, 16)) * 1.5 + 2.0 * np.linspace(-1, 1, 16)).astype(np.float32))
        oc = route(logits, sc, tc)
        og = route(logits.to(cuda_device), sg, tc)
        assert torch.equal(og.expert_index.cpu(), oc.expert_index)
        assert torch.equal(og.metrics["load"].cpu(), oc.metrics["load"])
        torch.testing.assert_close(og.combine_weights.cpu(), oc.combine_weights, rtol=1e-6, atol=1e-7)
        for key in sc:
            torch.testing.assert_close(og.state[key].cpu(), oc.state[key], rtol=1e-5, atol=1e-7)
        sc, sg = oc.state, og.state
    if strategy == "expert_choice":
        assert int((og.expert_index == 16).sum()) > 0  # sentinel slots were formed
        assert float(og.metrics["max_vio"]) == 0.0


def test_sentinel_plan_packs_and_combines_on_the_card(cuda_device):
    """Expert-choice's sentinel slots (index m, weight 0) through the
    dispatch plan on CUDA: no device assert, and pack/combine/counts equal
    to the CPU's."""
    from repro_torch.core import expert_choice_select, make_dispatch_plan

    rng = np.random.default_rng(2)
    s = torch.softmax(torch.from_numpy(
        (rng.standard_normal((512, 16)) + 3.0 * np.linspace(-1, 1, 16)).astype(np.float32)), dim=-1)
    w, idx = expert_choice_select(s, 4)
    assert int((idx == 16).sum()) > 0
    x = torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        plan = make_dispatch_plan(idx.to(dev), 16, 160)
        buf = plan.pack(x.to(dev))
        y = plan.combine(buf * 2.0, w.to(dev))
        outs.append((buf.cpu(), y.cpu(), plan.counts.cpu()))
    torch.cuda.synchronize()
    (bc, yc, cc), (bg, yg, cg) = outs
    assert torch.equal(bg, bc) and torch.equal(cg, cc)
    torch.testing.assert_close(yg, yc, rtol=1e-6, atol=1e-6)


def test_expert_choice_trains_full_width_through_the_kernels(cuda_device):
    """Two full-width minimind-moe-16e steps with expert_choice (batch 4 x
    512): K1 once and K2 nine times per MoE layer and step, no K3, finite
    losses, MaxVio 0."""
    full = configs.get("minimind_moe_16e")
    cfg = dataclasses.replace(full, routing=dataclasses.replace(
        full.routing, strategy="expert_choice", use_kernel=True))
    model = Model(cfg)
    opt = from_model_config(cfg)
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt, constant(1e-3))
    moe_gemm.reset_launch_counts()
    bip_admm.reset_launch_counts()
    losses = []
    for batch in make_batches(cfg, 4, 512, 2, device=cuda_device):
        state, mets = step(state, batch)
        losses.append(float(mets["loss"]))
    n_moe, steps = cfg.n_layers, 2
    assert moe_gemm.grouped_gated_ffn_in.launches == n_moe * steps
    assert moe_gemm.grouped_matmul.launches == n_moe * 9 * steps
    assert bip_admm.bip_dual_update.launches == 0
    assert all(np.isfinite(losses))
    assert float(mets["max_vio_per_layer"].max()) == 0.0


def _telemetry_run(cfg, steps, telemetry=None, seed=0):
    from repro_torch.data import SyntheticBatchStream
    from repro_torch.training import train_loop

    model = Model(cfg)
    stream = SyntheticBatchStream(cfg, 4, 64, steps, seed=seed, device="cuda")
    return train_loop(model, stream, lr=1e-3, warmup_steps=1, total_steps=steps, telemetry=telemetry)


def test_telemetry_is_bitwise_transparent_on_the_card(cuda_device):
    """5 reduced-width steps through K1/K2/K3, with and without the device
    ring (flush_every 2: two drains and a partial window): every param,
    moment, router state and loss bitwise equal; one record per step with
    integer loads summing to n·k per layer."""
    from repro_torch.optim.adamw import tree_paths
    from repro_torch.telemetry import MemorySink, TrainTelemetry

    cfg = _reduced_kernel_cfg()
    s0, l0 = _telemetry_run(cfg, 5)
    sink = MemorySink()
    s1, l1 = _telemetry_run(cfg, 5, TrainTelemetry(sink, flush_every=2))
    assert l0.losses == l1.losses

    def leaves(s):
        return tree_paths({"p": s.params, "mu": s.opt_state["mu"], "nu": s.opt_state["nu"],
                           "r": s.router_states})

    for (path, a), (_, b) in zip(leaves(s0), leaves(s1)):
        assert torch.equal(a, b), path
    recs = [r for r in sink.records if r["kind"] == "train_step"]
    assert [r["step"] for r in recs] == list(range(5))
    k = cfg.routing.top_k
    for r in recs:
        load = np.asarray(r["load_per_layer"])
        assert load.dtype.kind == "i" and (load.sum(axis=1) == 4 * 64 * k).all()
        assert np.isclose(r["ce_loss"], l0.losses[r["step"]])


def test_ring_writes_and_drains_without_a_host_sync(cuda_device):
    """MetricStream.accumulate and TrainTelemetry.after_step (the drain's
    event records, the side-stream copy into pinned memory, the older
    window's materialization) run under set_sync_debug_mode('error')."""
    from repro_torch.telemetry import MemorySink, TrainTelemetry

    cfg = _reduced_kernel_cfg()
    model = Model(cfg)
    opt = from_model_config(cfg)
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt, constant(1e-3))
    sink = MemorySink()
    tel = TrainTelemetry(sink, flush_every=2)
    for i, batch in enumerate(make_batches(cfg, 4, 64, 7, device=cuda_device)):
        state, mets = step(state, batch)
        float(mets["loss"])
        tel.ensure_built(mets)
        assert tel.buf.f_host.is_pinned() and tel.buf.f.is_cuda
        torch.cuda.set_sync_debug_mode("error")
        try:
            tel.stream.accumulate(tel.buf, mets, i)
            tel.after_step(i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if i == 4:  # windows [0, 1] and [2, 3] drained, the first materialized
            assert [r["step"] for r in sink.records] == [0, 1]
    tel.finish()
    assert [r["step"] for r in sink.records] == list(range(7))
    last = sink.records[-1]
    assert np.isclose(last["ce_loss"], float(mets["ce_loss"]))
    assert np.array_equal(last["load_per_layer"], mets["load_per_layer"].cpu().numpy())


def test_profiler_window_names_the_kernels_and_spans(cuda_device, tmp_path):
    """A --profile window of one full-width step (bf16 compute, batch 4 x
    64) on the card: the Chrome trace names K1, K2 and K3 and the
    reference's span names, and holds one step."""
    from repro_torch.telemetry import Profiler, TrainTelemetry

    full = configs.get("minimind_moe_16e")
    cfg = dataclasses.replace(full, routing=dataclasses.replace(full.routing, use_kernel=True))
    prof = Profiler((1, 1), log_dir=str(tmp_path))
    _telemetry_run(cfg, 3, TrainTelemetry(None, flush_every=2, profiler=prof))
    import json

    events = json.load(open(prof.trace_path))["traceEvents"]
    kernels = " ".join(e["name"] for e in events if e.get("cat") == "kernel")
    for name in ("wgmma_gemm_kernel<true", "wgmma_gemm_kernel<false", "bip_dual_update_kernel"):
        assert name in kernels, name
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]  # host-side ranges
    for name in ("train/fwd_bwd", "train/apply", "router/score_adjust", "moe/gemm", "telemetry/accumulate"):
        assert name in spans, name
    assert spans.count("train/fwd_bwd") == 1


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_sequential_on_the_card(cuda_device, groups):
    """The chunked SSD against the step-by-step recurrence on CUDA tensors,
    fp32, zamba2's head and state widths (S not a multiple of the chunk)."""
    from repro_torch.models import mamba2

    g = torch.Generator(device=cuda_device).manual_seed(groups)
    b, s, h, p, n = 2, 200, 16, 64, 64
    rnd = lambda *shape: torch.randn(*shape, device=cuda_device, generator=g)  # noqa: E731
    args = (rnd(b, s, h, p), torch.nn.functional.softplus(rnd(b, s, h) - 2.0),
            torch.log(torch.linspace(1.0, 16.0, h, device=cuda_device)), rnd(b, s, groups, n),
            rnd(b, s, groups, n), torch.ones(h, device=cuda_device))
    init = rnd(b, h, n, p)
    y, st = mamba2.ssd_chunked(*args, chunk=128, init_state=init)
    yr, sr = mamba2.ssd_reference(*args, init_state=init)
    assert y.device.type == "cuda"
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4 * yr.abs().max().item())
    torch.testing.assert_close(st, sr, rtol=1e-4, atol=1e-4 * sr.abs().max().item())


def test_kernels_match_plain_at_the_llama4_serving_shape(cuda_device):
    """K1/K2 in bf16 at llama4-scout's serving shape (E16 C40 D5120 F8192):
    one bf16 rounding of the plain version."""
    x, wg, wu, wd = _inputs((16, 40, 5120, 8192), torch.bfloat16, cuda_device)
    moe_gemm.reset_launch_counts()
    h = moe_gemm.grouped_gated_ffn_in(x, wg, wu)
    y = moe_gemm.grouped_matmul(h, wd)
    torch.cuda.synchronize()
    assert moe_gemm.grouped_gated_ffn_in.launches == 1 and moe_gemm.grouped_matmul.launches == 1
    hp, yp = moe_gemm.grouped_gated_ffn_in_plain(x, wg, wu), moe_gemm.grouped_matmul_plain(h, wd)
    torch.testing.assert_close(h.float(), hp.float(), rtol=2.0**-6, atol=2.0**-8 * hp.abs().max().item())
    torch.testing.assert_close(y.float(), yp.float(), rtol=2.0**-6, atol=2.0**-8 * yp.abs().max().item())


def test_reduced_zamba2_serves_on_the_card(cuda_device):
    """The hybrid stack (mamba layers, the shared block's own K/V per use)
    through prefill_chunk and decode_step on the card: the same logits as
    on the CPU from the same params (fp32 compute; 1e-4)."""
    cfg = configs.reduced_for_smoke("zamba2_7b")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    params = cpu.init(0)
    gparams = _to(params, cuda_device)
    rng = np.random.default_rng(0)
    caches = [m.init_slot_cache(p, 2, 32) for m, p in ((cpu, params), (gpu, gparams))]
    states = [cpu.init_router_states(), gpu.init_router_states()]
    for c, lens in ((6, [6, 3]), (6, [4, 6]), (1, None)):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, c)))
        outs = []
        for i, (m, p) in enumerate(((cpu, params), (gpu, gparams))):
            lengths = None if lens is None else torch.tensor(lens, device=m.device)
            logits, caches[i], states[i], _ = m.prefill_chunk(p, tok.to(m.device), caches[i], states[i],
                                                             lengths)
            outs.append(logits.cpu())
        valid = torch.ones((2, c), dtype=torch.bool) if lens is None else \
            torch.arange(c)[None, :] < torch.tensor(lens)[:, None]
        torch.testing.assert_close(outs[1][valid], outs[0][valid], rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_packed_prefill_launches_the_kernels(cuda_device):
    """Two packed steps (a stream spread over a second row, two fresh
    prompts sharing a row, then decodes) of reduced minimind-moe-16e with
    the full 16e / top-4 table, top-k routing and use_kernel=True, fp32:
    the card's logits on real columns and MoE load against the CPU port's
    on the same params (1e-4), with K1 and K2 launched once per MoE layer
    per step."""
    full = configs.get("minimind_moe_16e")
    cfg = configs.reduced_for_smoke(
        "minimind_moe_16e", vocab_size=128,
        routing=dataclasses.replace(full.routing, strategy="topk", use_kernel=True),
    )
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    params = cpu.init(0)
    gparams = _to(params, cuda_device)
    caches = [m.init_slot_cache(p, 4, 32) for m, p in ((cpu, params), (gpu, gparams))]
    states = [cpu.init_router_states(), gpu.init_router_states()]
    rng = np.random.default_rng(0)
    # (row, col, first position, n, segment, slot written, cache row read)
    steps = [[(0, 0, 0, 8, 0, 0, 0), (1, 0, 8, 6, 0, 0, 0), (2, 0, 0, 3, 1, 2, 2), (2, 3, 0, 4, 2, 3, 2)],
             [(0, 0, 14, 8, 0, 0, 0), (1, 0, 22, 6, 0, 0, 0), (2, 0, 3, 1, 0, 2, 2), (3, 0, 4, 1, 0, 3, 3)]]
    moe_gemm.reset_launch_counts()
    for runs in steps:
        pos = torch.full((4, 8), 7)
        seg, ws = torch.full((4, 8), -1), torch.full((4, 8), -1)
        rows = torch.arange(4)
        for r, c0, p0, n, s, slot, reads in runs:
            pos[r, c0:c0 + n] = torch.arange(p0, p0 + n)
            seg[r, c0:c0 + n], ws[r, c0:c0 + n], rows[r] = s, slot, reads
        tok = torch.as_tensor(rng.integers(0, 128, (4, 8)))
        outs = []
        for i, (m, p) in enumerate(((cpu, params), (gpu, gparams))):
            packed = {k: t.to(m.device) for k, t in
                      (("positions", pos), ("segments", seg), ("write_slots", ws), ("cache_rows", rows))}
            with torch.no_grad():
                logits, caches[i], states[i], mets = m.prefill_chunk(p, tok.to(m.device), caches[i], states[i],
                                                                     **packed)
            outs.append((logits.cpu(), mets["moe_load"].cpu()))
        valid = seg >= 0
        torch.testing.assert_close(outs[1][0][valid], outs[0][0][valid], rtol=1e-4, atol=1e-4)
        assert torch.equal(outs[1][1], outs[0][1])
    torch.cuda.synchronize()
    assert moe_gemm.grouped_gated_ffn_in.launches == cfg.n_layers * len(steps)
    assert moe_gemm.grouped_matmul.launches == cfg.n_layers * len(steps)


# ------------------------------------------------------------- K4 attention

# (B, S, H, KV, hd): the cells' shapes (s512 at 16e and 64e, s2048), a
# ragged S, GQA at a ragged S, phi4-mini's training shape (hd 128, GQA)
FLASH_SHAPES = [(32, 512, 8, 8, 64), (8, 2048, 8, 8, 64), (2, 1000, 8, 8, 64), (2, 1000, 8, 2, 64),
                (2, 2048, 24, 8, 128)]


def _qkv(b, s, h, kv, hd, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, hd, device=dev, generator=g).bfloat16()
    k = torch.randn(b, s, kv, hd, device=dev, generator=g).bfloat16()
    v = torch.randn(b, s, kv, hd, device=dev, generator=g).bfloat16()
    do = torch.randn(b, s, h, hd, device=dev, generator=g).bfloat16()
    return q, k, v, do


def _grads(fn, q, k, v, do):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves)
    o.backward(do.to(o.dtype))
    return [o.detach()] + [t.grad for t in leaves]


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def flash_errors(a, b, ref):
    """(max error, relative L2 error) of a and of b against ref, and whether
    a is at least as close as b (the rule of test_flash_attention_matches_plain)."""
    ref = ref.float()
    err, err_b = _max_err(a, ref), _max_err(b, ref)
    rel, rel_b = (float((t.float() - ref).norm() / ref.norm()) for t in (a, b))
    ok = rel <= 1.1 * rel_b and err <= max(1.5 * err_b, 2.0**-7 * float(ref.abs().max()))
    return (err, rel), (err_b, rel_b), ok


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_matches_plain(cuda_device, shape, monkeypatch):
    """K4's output, log-sum-exp and dq/dk/dv against the plain version.
    Tolerance: each of the kernel's bf16 results is at least as close to
    the plain version run in fp32 on the same bf16 inputs as the plain
    version run in bf16 is (it rounds the logits and dP, the kernel keeps
    them fp32): in relative L2 error, with 10% room, and in the largest
    error, with 1.5x room or up to one bf16 ulp of the largest entry (2^-7
    of it): two bf16 outputs that round nearly equal fp32 sums differ by
    that much anywhere, and the largest errors of both sides are at that
    level. Readings on an H100 (80GB HBM3, 700 W) over seeds 0-7 at each
    of FLASH_SHAPES (40 draws): the largest error, kernel over plain bf16,
    0.56-0.89x for o but up to 2.3x for dk (0.0274 against 0.0118 at 32 x
    512, seed 4) and 2.4x for dq, so the 1.5x clause alone would not hold;
    against 2^-7 of the largest entry it reads at most 0.39 (o), 0.81
    (dq), 0.80 (dk), 0.53 (dv). Relative L2, kernel over plain bf16: at
    most 0.89 (o), 1.08 (dq), 1.06 (dk), 1.00 (dv). The log-sum-exp (fp32
    on both sides) within 1e-4 absolute: ex2.approx and the sum order."""
    q, k, v, do = _qkv(*shape, cuda_device)
    plain = flash_attn.flash_attention_plain

    def forbidden(*a, **kw):
        raise AssertionError("a CUDA tensor must not take the plain version")

    monkeypatch.setattr(flash_attn, "flash_attention_plain", forbidden)
    flash_attn.reset_launch_counts()
    got = _grads(flash_attn.flash_attention, q, k, v, do)
    o_lse, lse = flash_attn._forward(q, k, v)
    lse = lse[..., : q.shape[1]]
    torch.cuda.synchronize()
    assert flash_attn.flash_attention.launches == 2 and flash_attn.flash_attention.bwd_launches == 1
    assert torch.equal(o_lse, got[0])
    bf16 = _grads(lambda *t: plain(*t)[0], q, k, v, do)
    f32 = _grads(lambda *t: plain(*t)[0], q.float(), k.float(), v.float(), do)
    for name, a, b, ref in zip(("o", "dq", "dk", "dv"), got, bf16, f32):
        assert bool(torch.isfinite(a).all()), name
        kernel, plain_bf16, ok = flash_errors(a, b, ref)
        assert ok, f"{name}: kernel (max, rel L2) {kernel} vs plain bf16 {plain_bf16}"
    want_lse = plain(q.float(), k.float(), v.float())[1]
    assert _max_err(lse, want_lse) <= 1e-4


def test_flash_attention_backward_is_deterministic(cuda_device):
    q, k, v, do = _qkv(8, 2048, 8, 8, 64, cuda_device, seed=3)
    first = _grads(flash_attn.flash_attention, q, k, v, do)
    for _ in range(2):
        again = _grads(flash_attn.flash_attention, q, k, v, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_refusals(cuda_device):
    q, k, v, _ = _qkv(1, 64, 8, 8, 64, cuda_device)
    flash_attn.reset_launch_counts()
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="head_dim"):
        big = [t.repeat(1, 1, 1, 4) for t in (q, k, v)]  # head_dim 256
        flash_attn.flash_attention(*big)
    with pytest.raises(ValueError, match="strides"):  # head_dim not unit-stride
        flash_attn.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="strides"):  # a base off the 16-byte grain
        flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)
        flash_attn.flash_attention(flat[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="on"):
        flash_attn.flash_attention(q, k.cpu(), v)
    assert flash_attn.flash_attention.launches == 0


def test_train_step_launches_k4(cuda_device):
    """One full-width minimind-moe-16e step (head_dim 64, bf16 compute):
    K4 once forward and once backward per layer; the chunked path's softmax
    never runs."""
    cfg = configs.get("minimind_moe_16e")
    model = Model(cfg, device=cuda_device)
    opt = from_model_config(cfg)
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt, constant(1e-3))
    batch = next(iter(make_batches(cfg, 2, 256, 1, device=cuda_device)))
    flash_attn.reset_launch_counts()
    state, mets = step(state, batch)
    torch.cuda.synchronize()
    assert flash_attn.flash_attention.launches == cfg.n_layers
    assert flash_attn.flash_attention.bwd_launches == cfg.n_layers
    assert np.isfinite(float(mets["loss"]))
