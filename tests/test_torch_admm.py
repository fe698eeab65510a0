"""Port vs reference: the BIP-ADMM dual iteration (K3), its dual update and
the fused kernel's launch plan, the kernel path of route(), and the
differentiable expert FFN (K1/K2).

The same numpy inputs go to the reference (its Pallas kernels in interpret
mode on the CPU, as its own tests run them) and to the port, whose wrappers
run their plain versions on CPU tensors. fp32 throughout. Tolerances:
  * K3's p and counts are exact (an order statistic and integer counts), so
    they are held EQUAL, as tests/test_kernels.py holds the reference's
    counts against its oracle (atol 0);
  * the dual update's q within 1e-6 of the reference (the same counts, then
    the same few fp32 operations in possibly fused order), and both within
    2/512 + 5e-3 of the exact sort-based dual: the reference's own bound for
    its histogram resolution (tests/test_kernels.py);
  * expert_ffn gradients atol/rtol 1e-4, the reference's own tolerance for
    its custom VJP against einsum autodiff (tests/test_kernels.py).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import router as jax_router  # noqa: E402
from repro.core.ref_bip import bip_dual_update as jax_exact_dual  # noqa: E402
from repro.core.ref_bip import expert_kth_index  # noqa: E402
from repro.kernels import bip_admm as jax_bip  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import router  # noqa: E402
from repro_torch.kernels import bip_admm, ops, ref  # noqa: E402

ARCH = "minimind_moe_16e"
DUAL_BOUND = 2.0 / 512 + 5e-3


def _scores(seed, n, m, skew=1.5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, m)) + skew * np.linspace(2, -2, m)[None, :]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("refined", [False, True])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("m", [4, 16, 64])
@pytest.mark.parametrize("n", [128, 257, 1000])
def test_iteration_matches_pallas_kernel(n, m, k, refined):
    """p equal and counts equal (atol 0), with the default [-1, 1) bounds and
    with the per-expert bounds a refine pass uses (the bin located from the
    coarse counts, as ops.bip_dual_update forms it)."""
    s = _scores(n + m + k, n, m)
    q = np.random.default_rng(1).uniform(0, 0.3, m).astype(np.float32)
    lo = hi = None
    if refined:
        _, cnt = jax_bip.bip_admm_iteration(jnp.asarray(s), jnp.asarray(q), top_k=k, block_n=128)
        rank = max(expert_kth_index(n, k, m), 0)
        lo_j, hi_j, _ = jax_bip.locate_bin(
            cnt, rank, 512, jnp.full((m,), -1.0), jnp.full((m,), 1.0)
        )
        lo, hi = np.asarray(lo_j), np.asarray(hi_j)
    pj, cj = jax_bip.bip_admm_iteration(
        jnp.asarray(s), jnp.asarray(q), top_k=k, block_n=128,
        lo=None if lo is None else jnp.asarray(lo), hi=None if hi is None else jnp.asarray(hi),
    )
    pt, ct = bip_admm.bip_admm_iteration(
        _t(s), _t(q), top_k=k, lo=None if lo is None else _t(lo), hi=None if hi is None else _t(hi)
    )
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_oracles_match_reference():
    """ref.bip_iteration_ref / histogram_counts_ref / bip_dual_update_ref
    against the reference's oracles of the same names."""
    s = _scores(3, 300, 16)
    q = np.random.default_rng(2).uniform(0, 0.2, 16).astype(np.float32)
    pj = np.asarray(jax_ref.bip_iteration_ref(jnp.asarray(s), jnp.asarray(q), top_k=4))
    pt = ref.bip_iteration_ref(_t(s), _t(q), top_k=4).numpy()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(
        ref.histogram_counts_ref(_t(s), _t(pt), n_bins=512).numpy(),
        np.asarray(jax_ref.histogram_counts_ref(jnp.asarray(s), jnp.asarray(pj), n_bins=512)),
    )
    np.testing.assert_array_equal(
        ref.bip_dual_update_ref(_t(s), _t(q), top_k=4, n_iters=3).numpy(),
        np.asarray(jax_ref.bip_dual_update_ref(jnp.asarray(s), jnp.asarray(q), top_k=4, n_iters=3)),
    )


@pytest.mark.parametrize("rank", [0, 37, 299])
def test_bin_location_matches_reference(rank):
    s = _scores(5, 300, 16)
    _, cnt = jax_bip.bip_admm_iteration(jnp.asarray(s), jnp.zeros(16), top_k=4, block_n=128)
    lo, hi = jnp.full((16,), -1.0), jnp.full((16,), 1.0)
    want = jax_bip.locate_bin(cnt, rank, 512, lo, hi)
    got = bip_admm.locate_bin(_t(cnt), rank, 512, _t(lo), _t(hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        bip_admm.q_from_histogram(_t(cnt), rank, 512).numpy(),
        np.asarray(jax_bip.q_from_histogram(cnt, rank, 512)), atol=1e-6,
    )


# (seed, n, m, k, T, warm start, refine)
DUAL_CASES = [
    (0, 512, 16, 4, 4, False, 1),
    (1, 1000, 64, 8, 2, False, 1),
    (2, 257, 4, 1, 4, False, 1),
    (3, 128, 16, 2, 2, False, 1),
    (4, 1000, 64, 8, 14, False, 1),  # minimind-moe-64e's own T
    (5, 512, 128, 2, 4, False, 1),   # arctic's m
    (6, 512, 16, 4, 4, True, 1),
    (7, 1000, 64, 8, 14, True, 1),
    (8, 512, 128, 2, 4, True, 1),
    (9, 512, 16, 4, 4, False, 0),
    (10, 1000, 64, 8, 4, True, 0),
    (11, 512, 16, 4, 4, True, 2),
    (12, 257, 4, 1, 4, False, 2),
]


@pytest.mark.parametrize("seed,n,m,k,t,warm,refine", DUAL_CASES)
def test_dual_update_matches_reference(seed, n, m, k, t, warm, refine):
    """The plain loop (what the CUDA kernel is held bit-equal to on the card)
    within 1e-6 of the reference's bip_dual_update (Pallas in interpret
    mode), cold or warm-started, with 0-2 refine passes; both within the
    histogram-resolution bound of the exact sort-based dual. On a CPU tensor
    ops.bip_dual_update is the plain loop."""
    s = _scores(seed, n, m)
    q0 = (np.random.default_rng(seed + 100).uniform(0, 0.3, m) if warm else np.zeros(m)).astype(
        np.float32)
    qj = np.asarray(jax_ops.bip_dual_update(
        jnp.asarray(s), jnp.asarray(q0), top_k=k, n_iters=t, refine=refine))
    qt = bip_admm.bip_dual_update_plain(_t(s), _t(q0), top_k=k, n_iters=t, refine=refine)
    assert torch.equal(ops.bip_dual_update(_t(s), _t(q0), top_k=k, n_iters=t, refine=refine), qt)
    qe = np.asarray(jax_exact_dual(jnp.asarray(s), jnp.asarray(q0), top_k=k, n_iters=t)[0])
    np.testing.assert_allclose(qt.numpy(), qj, atol=1e-6)
    np.testing.assert_allclose(qt.numpy(), qe, atol=DUAL_BOUND)
    np.testing.assert_allclose(qj, qe, atol=DUAL_BOUND)


@pytest.mark.parametrize("plain", [False, True])
def test_dual_update_capacity_slack_is_zero(plain):
    """k >= m: the capacity index runs past the column, q stays zero (no
    launch on the card)."""
    s = _scores(4, 8, 4)
    fn = bip_admm.bip_dual_update_plain if plain else ops.bip_dual_update
    q = fn(_t(s), torch.full((4,), 0.3), top_k=4, n_iters=4)
    np.testing.assert_array_equal(q.numpy(), 0.0)
    qj = jax_ops.bip_dual_update(jnp.asarray(s), jnp.full((4,), 0.3), top_k=4, n_iters=4)
    np.testing.assert_array_equal(np.asarray(qj), 0.0)


@pytest.mark.parametrize("n", [1, 257, 8191, 8192, 32768])
@pytest.mark.parametrize("m", [4, 16, 64, 128])
def test_launch_plan(m, n):
    """The fused kernel's plan at 512 bins, for either cluster size: the
    CTAs cover every row, the owners every expert, the shared memory fits
    and matches the kernel's layout, and the resident scores' stride is odd."""
    for cluster in (bip_admm.CLUSTER, bip_admm.PORTABLE_CLUSTER):
        plan = bip_admm.launch_plan(n, m, 512, cluster)
        assert plan.cluster == cluster and plan.threads == bip_admm.THREADS
        assert plan.rows_per_cta == -(-n // cluster)
        assert plan.rows_per_thread == -(-plan.rows_per_cta // plan.threads)
        assert plan.experts_per_owner == -(-m // cluster)
        assert 0 < plan.resident_rows <= plan.rows_per_cta
        assert plan.s_stride % 2 == 1 and plan.s_stride in (plan.resident_rows, plan.resident_rows + 1)
        fixed = 7 * m + plan.experts_per_owner * 513 + plan.rows_per_cta
        assert plan.smem_bytes == 4 * (fixed + m * plan.s_stride) <= bip_admm.MAX_SMEM
        if 4 * (fixed + m * (plan.rows_per_cta | 1)) <= bip_admm.MAX_SMEM:
            assert plan.resident_rows == plan.rows_per_cta  # every row stays on chip
    assert bip_admm.launch_plan(8192, 16, 512).resident_rows == 512  # 16e: 1 row per thread


@pytest.mark.parametrize("n,m,n_bins,cluster", [
    (0, 16, 512, 16),             # no rows
    (8192, 0, 512, 16),           # no experts
    (8192, 4096, 512, 16),        # 256 histograms per CTA: over 227 KB
    (8192, 16, 500, 16),          # not a power of two
    (8192, 16, 1, 16),
    (8192, 16, 8192, 16),         # over 4096 bins
    (8192, 16, 512, 4),           # a cluster of 4
    (16 * 60000, 16, 512, 16),    # p of a CTA's rows alone over 227 KB
])
def test_launch_plan_refuses(n, m, n_bins, cluster):
    with pytest.raises(ValueError, match="bip_admm"):
        bip_admm.launch_plan(n, m, n_bins, cluster)


def test_kernel_wrapper_cpu_path_and_bad_input(monkeypatch):
    """CPU tensors take the plain version: nothing is built or launched;
    malformed input raises."""

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(bip_admm, "build", no_build)
    bip_admm.reset_launch_counts()
    s = _t(_scores(6, 64, 16))
    p, cnt = bip_admm.bip_admm_iteration(s, torch.zeros(16), top_k=4)
    assert p.shape == (64,) and cnt.shape == (16, 512) and cnt.dtype == torch.float32
    q = ops.bip_dual_update(s, torch.zeros(16), top_k=4, n_iters=2)
    assert q.shape == (16,) and q.dtype == torch.float32
    assert bip_admm.bip_admm_iteration.launches == bip_admm.bip_dual_update.launches == 0
    with pytest.raises(TypeError):
        bip_admm.bip_admm_iteration(s.double(), torch.zeros(16), top_k=4)
    with pytest.raises(ValueError):
        bip_admm.bip_admm_iteration(s, torch.zeros(15), top_k=4)
    with pytest.raises(ValueError):
        bip_admm.bip_admm_iteration(s[:0], torch.zeros(16), top_k=4)
    with pytest.raises(ValueError):
        ops.bip_dual_update(s, torch.zeros(15), top_k=4, n_iters=2)


@pytest.mark.parametrize("sync", ["local", "global"])
def test_route_kernel_path_matches_reference(sync, monkeypatch):
    """route() with use_kernel=True and no mask, under either sync mode, over
    3 warm-started steps: q and the selection equal the reference's.

    Both routers see bit-identical scores (the port's route() runs on the
    reference's softmax output), for the reason test_torch_router.py gives:
    ulp noise in the gate would flip the LP-degenerate capacity-marginal
    tokens. The K3 dual update, selection and state are the port's own."""
    rc = jax_configs.get(ARCH).routing.to_router_config(use_kernel=True, sync=sync)
    tc = configs.get(ARCH).routing.to_router_config(use_kernel=True, sync=sync)
    monkeypatch.setattr(
        router, "compute_scores",
        lambda lg, cfg: _t(jax_router.compute_scores(jnp.asarray(lg.numpy()), rc)),
    )
    sj, st = {"q": jnp.zeros((16,), jnp.float32)}, {"q": torch.zeros(16)}
    rng = np.random.default_rng(11)
    for _ in range(3):
        logits = (rng.standard_normal((256, 16)) * 1.5 + np.linspace(-1, 1, 16)).astype(np.float32)
        oj = jax_router.route(jnp.asarray(logits), sj, rc)
        ot = router.route(_t(logits), st, tc)
        np.testing.assert_allclose(ot.state["q"].numpy(), np.asarray(oj.state["q"]), atol=1e-6)
        np.testing.assert_array_equal(ot.expert_index.numpy(), np.asarray(oj.expert_index))
        np.testing.assert_allclose(
            ot.combine_weights.numpy(), np.asarray(oj.combine_weights), rtol=1e-6
        )
        np.testing.assert_array_equal(ot.metrics["load"].numpy(), np.asarray(oj.metrics["load"]))
        sj, st = oj.state, ot.state


@pytest.mark.parametrize("shape", [(3, 40, 96, 200), (4, 130, 50, 260)])  # (E, C, D, F)
def test_expert_ffn_grads_match_reference(shape):
    """Gradients of sum(sin(expert_ffn)) for all four operands against
    jax.grad through the reference's custom VJP (Pallas, auto-padded)."""
    e, c, d, f = shape
    rng = np.random.default_rng(8)
    args = [
        (rng.standard_normal((e, c, d)) * 0.3).astype(np.float32),
        (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
        (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
        (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32),
    ]
    want = jax.grad(
        lambda *a: jnp.sum(jnp.sin(jax_ops.expert_ffn(*a))), argnums=(0, 1, 2, 3)
    )(*[jnp.asarray(a) for a in args])
    ts = [_t(a).requires_grad_(True) for a in args]
    torch.sin(ops.expert_ffn(*ts)).sum().backward()
    for t_, w in zip(ts, want):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_expert_ffn_backward_runs_eight_grouped_matmuls(monkeypatch):
    """The backward is K2 alone: eight grouped_matmul calls (two recomputed
    pre-activations, dh, dw_down, two halves of dx, dw_gate, dw_up), six of
    them on a transposed weight or activation view, and no other product."""
    calls = []
    inner = ops.moe_gemm.grouped_matmul

    def spy(h, w):
        calls.append((h.is_contiguous(), w.is_contiguous()))
        return inner(h, w)

    rng = np.random.default_rng(9)
    x = _t((rng.standard_normal((2, 5, 8)) * 0.3).astype(np.float32)).requires_grad_(True)
    ws = [_t((rng.standard_normal(s) * 0.1).astype(np.float32)).requires_grad_(True)
          for s in ((2, 8, 12), (2, 8, 12), (2, 12, 8))]
    y = ops.expert_ffn(x, *ws)
    monkeypatch.setattr(ops.moe_gemm, "grouped_matmul", spy)
    y.sum().backward()
    assert len(calls) == 8
    assert sum(not (a and b) for a, b in calls) == 6  # dh, dwd, dx x2, dwg, dwu
