"""Port vs reference: BIP duals, top-k tie rule, dispatch plan, route().

Scores, masks and warm starts are drawn with numpy and handed to both
packages. The bisection and the dispatch plan are held bit-equal: the port
keeps the reference's arithmetic step for step (exact midpoint ladders,
exact integer counts, gathered bounds; a stable argsort).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import balancers as jax_balancers  # noqa: E402
from repro.core import ref_bip as jax_ref_bip  # noqa: E402
from repro.core import router as jax_router  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import balancers, ref_bip, router  # noqa: E402
from repro_torch.core.metrics import balance_metrics, expert_load  # noqa: E402


ARCH = "minimind_moe_16e"


def _softmax(z):
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _scores(n, m, seed):
    rng = np.random.default_rng(seed)
    skew = rng.standard_normal(m) * 0.7  # uneven expert popularity
    return _softmax(rng.standard_normal((n, m)).astype(np.float32) * 1.5 + skew)


@pytest.mark.parametrize("n_real", [0, 1, 23, 64])
@pytest.mark.parametrize("fanout", [1, 32])
def test_masked_global_dual_update_is_bit_equal(n_real, fanout):
    n, m, k = 64, 16, 4
    rng = np.random.default_rng(n_real + fanout)
    s = _scores(n, m, seed=n_real)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:n_real]] = True
    q0 = (rng.random(m) * 0.05).astype(np.float32)
    kw = dict(top_k=k, n_iters=4, n_bisect=26, fanout=fanout, score_bounds=(0.0, 1.0))
    qj, pj = jax_ref_bip.bip_dual_update_global(
        jnp.asarray(s), jnp.asarray(q0), token_mask=jnp.asarray(mask), **kw
    )
    qt, pt = ref_bip.bip_dual_update_global(
        torch.from_numpy(s), torch.from_numpy(q0), token_mask=torch.from_numpy(mask), **kw
    )
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("fanout", [1, 7])
def test_threshold_order_statistic_is_bit_equal(fanout):
    rng = np.random.default_rng(fanout)
    x = rng.standard_normal((50, 6)).astype(np.float32)
    for kth in (0, 49):
        want = jax_ref_bip.kth_largest_threshold(jnp.asarray(x), kth, axis=0, fanout=fanout)
        got = ref_bip.kth_largest_threshold(torch.from_numpy(x), kth, dim=0, fanout=fanout)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sort_dual_update_matches():
    s = _scores(48, 16, seed=3)
    q0 = np.zeros(16, np.float32)
    qj, pj = jax_ref_bip.bip_dual_update(jnp.asarray(s), jnp.asarray(q0), top_k=4, n_iters=4)
    qt, pt = ref_bip.bip_dual_update(torch.from_numpy(s), torch.from_numpy(q0), top_k=4, n_iters=4)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert ref_bip.bisect_rounds(26, 32) == jax_ref_bip.bisect_rounds(26, 32) == 5


def test_topk_tie_rule_matches_lax_top_k():
    """Equal scores select the lower expert index first, as lax.top_k."""
    rng = np.random.default_rng(0)
    # heavy ties: few distinct values, including padded rows' uniform 1/m
    corrected = rng.integers(0, 3, (40, 16)).astype(np.float32) / 4.0
    corrected[:8] = 1.0 / 16
    rc = jax_configs.get("minimind_moe_16e").routing.to_router_config()
    tc = configs.get("minimind_moe_16e").routing.to_router_config()
    wj, ij = jax_balancers.topk_select(jnp.asarray(corrected), jnp.asarray(corrected), rc)
    wt, it = balancers.topk_select(torch.from_numpy(corrected), torch.from_numpy(corrected), tc)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("masked", [False, True])
def test_dispatch_plan_is_bit_equal(masked):
    n, k, m, cap = 40, 4, 16, 7  # capacity overflows for popular experts
    rng = np.random.default_rng(masked)
    idx = np.stack([rng.choice(m, k, replace=False, p=np.linspace(1, 3, m) / np.linspace(1, 3, m).sum())
                    for _ in range(n)]).astype(np.int32)
    mask = rng.random(n) < 0.7 if masked else None
    pj = jax_router.make_dispatch_plan(
        jnp.asarray(idx), m, cap, None if mask is None else jnp.asarray(mask)
    )
    pt = router.make_dispatch_plan(
        torch.from_numpy(idx), m, cap, None if mask is None else torch.from_numpy(mask)
    )
    for name in ("order", "offsets", "pos", "keep"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)))
    np.testing.assert_array_equal(pt.counts.numpy(), np.asarray(pj.counts))
    x = rng.standard_normal((n, 8)).astype(np.float32)
    w = rng.random((n, k)).astype(np.float32)
    buf_j = pj.pack(jnp.asarray(x))
    buf_t = pt.pack(torch.from_numpy(x))
    np.testing.assert_array_equal(buf_t.numpy(), np.asarray(buf_j))
    y = rng.standard_normal(buf_t.shape).astype(np.float32)
    np.testing.assert_allclose(
        pt.combine(torch.from_numpy(y), torch.from_numpy(w)).numpy(),
        np.asarray(pj.combine(jnp.asarray(y), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6,
    )


def test_compute_scores_match():
    rc = jax_configs.get("minimind_moe_16e").routing.to_router_config()
    tc = configs.get("minimind_moe_16e").routing.to_router_config()
    logits = np.random.default_rng(2).standard_normal((64, 16)).astype(np.float32) * 2
    np.testing.assert_allclose(
        router.compute_scores(torch.from_numpy(logits), tc).numpy(),
        np.asarray(jax_router.compute_scores(jnp.asarray(logits), rc)),
        rtol=1e-6, atol=1e-7,
    )


def test_route_bip_masked_three_warm_steps(monkeypatch):
    """Full 16e/top-4 table, serving mask, 3 warm-started steps: weights and q
    allclose, selections and load bit-equal on the real rows.

    Both routers see bit-identical scores: the port's route() runs on the
    reference's softmax output. XLA's and torch's exp differ in the last
    ulp (test_compute_scores_match), and the converged BIP duals make the
    capacity-marginal tokens exactly indifferent between two experts (the
    LP degeneracy DESIGN.md §"What parity means under degeneracy" describes),
    so ulp noise in the gate would flip those ties. Everything after the gate
    function — dual update, selection, state, metrics — is the port's.
    """
    rc = jax_configs.get("minimind_moe_16e").routing.to_router_config()
    tc = configs.get("minimind_moe_16e").routing.to_router_config()
    monkeypatch.setattr(
        router, "compute_scores",
        lambda lg, cfg: torch.from_numpy(
            np.array(jax_router.compute_scores(jnp.asarray(lg.numpy()), rc))
        ),
    )
    sj = {"q": jnp.zeros((16,), jnp.float32)}
    st = {"q": torch.zeros(16)}
    rng = np.random.default_rng(7)
    for step in range(3):
        n = 96
        logits = (rng.standard_normal((n, 16)) * 1.5 + np.linspace(-1, 1, 16)).astype(np.float32)
        mask = rng.random(n) < 0.6
        logits[~mask] = 0.0  # padded rows score uniform, as the model feeds them
        oj = jax_router.route(jnp.asarray(logits), sj, rc, token_mask=jnp.asarray(mask))
        ot = router.route(torch.from_numpy(logits), st, tc, token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(ot.state["q"].numpy(), np.asarray(oj.state["q"]), atol=1e-7)
        np.testing.assert_array_equal(ot.expert_index.numpy()[mask], np.asarray(oj.expert_index)[mask])
        np.testing.assert_allclose(
            ot.combine_weights.numpy()[mask], np.asarray(oj.combine_weights)[mask], rtol=1e-6
        )
        load_j = np.bincount(np.asarray(oj.expert_index)[mask].ravel(), minlength=16)
        np.testing.assert_array_equal(
            expert_load(ot.expert_index[torch.from_numpy(mask)], 16).numpy(), load_j
        )
        sj, st = oj.state, ot.state


def test_dual_watchdog_matches_reference():
    """guard_duals: a poisoned carried q resets to zeros in both packages,
    and a healthy one passes bitwise."""
    rc = jax_configs.get(ARCH).routing.to_router_config(guard_duals=True)
    tc = configs.get(ARCH).routing.to_router_config(guard_duals=True)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((32, 16)).astype(np.float32)
    mask = np.ones(32, bool)
    for q0 in (np.full(16, np.nan, np.float32), (rng.random(16) * 0.01).astype(np.float32)):
        oj = jax_router.route(jnp.asarray(logits), {"q": jnp.asarray(q0)}, rc, token_mask=jnp.asarray(mask))
        ot = router.route(torch.from_numpy(logits), {"q": torch.from_numpy(q0)}, tc, token_mask=torch.from_numpy(mask))
        assert np.isfinite(ot.state["q"].numpy()).all()
        np.testing.assert_allclose(ot.state["q"].numpy(), np.asarray(oj.state["q"]), atol=1e-6)
    q, ok = ref_bip.sanitize_duals(torch.tensor([0.5, -200.0]), 100.0)
    assert not bool(ok) and q.tolist() == [0.0, 0.0]


def test_balance_metrics_match():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 16, (30, 4)).astype(np.int32)
    from repro.core.metrics import balance_metrics as jax_balance_metrics

    mj = jax_balance_metrics(jnp.asarray(idx), 16, 4)
    mt = balance_metrics(torch.from_numpy(idx), 16, 4)
    np.testing.assert_array_equal(mt["load"].numpy(), np.asarray(mj["load"]))
    for key in ("max_vio", "min_load_frac", "load_entropy", "dropped_frac_cap1"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-6)


def test_unmasked_kernel_dual_update_raises():
    tc = configs.get("minimind_moe_16e").routing.to_router_config(use_kernel=True)
    logits = torch.zeros(8, 16)
    with pytest.raises(NotImplementedError, match="K3"):
        router.route(logits, {"q": torch.zeros(16)}, tc)
    # the masked (serving) form runs the plain bisection
    out = router.route(logits, {"q": torch.zeros(16)}, tc, token_mask=torch.ones(8, dtype=torch.bool))
    assert out.expert_index.shape == (8, 4)
