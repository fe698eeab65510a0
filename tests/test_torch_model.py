"""Port vs reference: attention against the slot cache, the MoE layer, and
teacher-forced chunked prefill of reduced minimind-moe-16e.

The model is reduced minimind-16e with the FULL routing table (16 experts,
top-4), as benchmarks/balance_sweep.py runs it, fp32 compute. Parameters
come from the reference's `Model.init` and reach the port through
`repro_torch.convert`; tokens and caches are drawn with numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    load_npz_params,
    load_npz_tree,
    params_from_numpy,
    router_states_from_numpy,
    unstack_blocks,
)
from repro_torch.models import Model, common, moe  # noqa: E402

ARCH = "minimind_moe_16e"


def _cfgs(use_kernel=True, **kw):
    jfull, tfull = jax_configs.get(ARCH), configs.get(ARCH)
    jr = dataclasses.replace(jfull.routing, use_kernel=use_kernel)
    tr = dataclasses.replace(tfull.routing, use_kernel=use_kernel)
    return (
        jax_configs.reduced_for_smoke(ARCH, routing=jr, vocab_size=128, **kw),
        configs.reduced_for_smoke(ARCH, routing=tr, vocab_size=128, **kw),
    )


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jm, jp, Model(tcfg, device="cpu"), tp


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("layer_kind", ["global", "local"])
def test_attention_chunk_mixed_lengths(layer_kind):
    jcfg, tcfg = _cfgs(attn_pattern=(layer_kind,), window_size=12 if layer_kind == "local" else 0)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    attn_j = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"][0]["attn"])
    attn_t = jax.tree.map(lambda a: _t(a), jax.device_get(attn_j))
    rng = np.random.default_rng(0)
    b, c, d, cap = 4, 8, jcfg.d_model, 12 if layer_kind == "local" else 32
    kv, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim
    x = rng.standard_normal((b, c, d)).astype(np.float32)
    k = rng.standard_normal((b, cap, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, cap, kv, hd)).astype(np.float32)
    pos = np.array([0, 3, 10, 17], np.int32)  # the local ring wraps for rows 2, 3
    lengths = np.array([8, 0, 1, 5], np.int32)
    oj, cj = jax_common.attention_chunk(
        attn_j, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)},
        jcfg, layer_kind=layer_kind, lengths=jnp.asarray(lengths),
    )
    ot, ct = common.attention_chunk(
        attn_t, _t(x), {"k": _t(k), "v": _t(v), "pos": _t(pos).long()},
        tcfg, layer_kind=layer_kind, lengths=_t(lengths).long(),
    )
    valid = np.arange(c)[None, :] < lengths[:, None]
    np.testing.assert_allclose(ot.numpy()[valid], np.asarray(oj)[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ct["v"].numpy(), np.asarray(cj["v"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


def test_moe_ffn_local_use_kernel(models):
    jm, jp, tm, tp = models
    jcfg, tcfg = jm.cfg, tm.cfg
    rng = np.random.default_rng(3)
    n = 40
    x = rng.standard_normal((n, jcfg.d_model)).astype(np.float32)
    mask = rng.random(n) < 0.7
    x[~mask] = 0.0  # padded rows arrive zeroed, as the model feeds them
    pj = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"][0]["moe"])
    pt = tp["stack"]["layers"][0]["moe"]
    q0 = np.abs(rng.standard_normal(16)).astype(np.float32) * 0.01
    yj, sj, _, mj = jax_moe.moe_ffn_local(
        pj, jnp.asarray(x), {"q": jnp.asarray(q0)}, jcfg, token_mask=jnp.asarray(mask)
    )
    yt, st, _, mt = moe.moe_ffn_local(pt, _t(x), {"q": _t(q0)}, tcfg, token_mask=_t(mask))
    np.testing.assert_allclose(yt.numpy()[mask], np.asarray(yj)[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st["q"].numpy(), np.asarray(sj["q"]), atol=1e-6)
    np.testing.assert_array_equal(mt["load"].numpy(), np.asarray(mj["load"]))


def _strategy_models(strategy):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, routing=dataclasses.replace(jcfg.routing, strategy=strategy))
    tcfg = dataclasses.replace(tcfg, routing=dataclasses.replace(tcfg.routing, strategy=strategy))
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, Model(tcfg, device="cpu"), params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def _port_state(jm, jc, js):
    """The reference's cache and router states in the port's layout."""
    layers = unstack_blocks(jax.device_get(jc["blocks"]), jm.cfg)
    cache = {"layers": [{k: _t(v) for k, v in layer.items()} for layer in layers]}
    for layer in cache["layers"]:
        layer["pos"] = layer["pos"].long()
    return cache, router_states_from_numpy(jax.device_get(js), jm.cfg)


STEPS = [[8, 5, 0], [8, 8, 3], [1, 8, 1], [1, 1, 1]]  # prefill, decode, idle rows


def test_teacher_forced_prefill_chunks_topk():
    """4 chunked steps, full 16e/top-4 table, token-choice top-k routing:
    logits (atol 1e-4), caches and q allclose, moe_load bit-equal."""
    jm, jp, tm, tp = _strategy_models("topk")
    b, c = 3, 8
    jc, js = jm.init_slot_cache(jp, b, 32), jm.init_router_states()
    tc, ts = tm.init_slot_cache(tp, b, 32), tm.init_router_states()
    rng = np.random.default_rng(5)
    for lens in STEPS:
        tokens = rng.integers(0, 128, (b, c)).astype(np.int32)
        lengths = np.asarray(lens, np.int32)
        lj, jc, js, mj = jm.prefill_chunk(jp, jnp.asarray(tokens), jc, js, jnp.asarray(lengths))
        lt, tc, ts, mt = tm.prefill_chunk(tp, _t(tokens).long(), tc, ts, _t(lengths).long())
        valid = np.arange(c)[None, :] < lengths[:, None]
        np.testing.assert_allclose(lt.numpy()[valid], np.asarray(lj)[valid], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(mt["moe_load"].numpy(), np.asarray(mj["moe_load"]))
        np.testing.assert_allclose(float(mt["max_vio"]), float(mj["max_vio"]), rtol=1e-6)
        want_cache, want_states = _port_state(jm, jc, js)
        for got, want in zip(tc["layers"], want_cache["layers"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(got["pos"].numpy(), want["pos"].numpy())
        for got, want in zip(ts, want_states):
            np.testing.assert_allclose(got["q"].numpy(), want["q"].numpy(), atol=1e-6)


def test_teacher_forced_prefill_chunks_bip():
    """The same 4 steps under BIP routing, each started from the reference's
    own cache and duals (teacher-forced in state as well as tokens).

    BIP's capacity boundary is LP-degenerate (DESIGN.md §"What parity means
    under degeneracy"): the converged dual leaves each capacity-marginal
    token indifferent between two experts to ~1e-7, and the two frameworks'
    fp32 arithmetic (softmax exp, einsum order) differs by ulps, so a few
    marginal tokens per layer land on the other, equally optimal expert;
    their changed outputs then feed the next layer. The contract held here:
    the first MoE layer's dual (its inputs agree to ulps) allclose at 1e-6,
    every layer's dual within 0.05, logits allclose on the first step from
    the fresh state, the step's real-token load total exact, and per-expert
    load within an L1 distance of a quarter of that total.
    """
    jm, jp, tm, tp = _strategy_models("bip")
    b, c = 3, 8
    jc, js = jm.init_slot_cache(jp, b, 32), jm.init_router_states()
    rng = np.random.default_rng(5)
    for step, lens in enumerate(STEPS):
        tokens = rng.integers(0, 128, (b, c)).astype(np.int32)
        lengths = np.asarray(lens, np.int32)
        tc, ts = _port_state(jm, jc, js)
        lj, jc, js, mj = jm.prefill_chunk(jp, jnp.asarray(tokens), jc, js, jnp.asarray(lengths))
        lt, tc, ts, mt = tm.prefill_chunk(tp, _t(tokens).long(), tc, ts, _t(lengths).long())
        valid = np.arange(c)[None, :] < lengths[:, None]
        if step == 0:
            np.testing.assert_allclose(lt.numpy()[valid], np.asarray(lj)[valid], rtol=1e-4, atol=1e-4)
        load_t, load_j = mt["moe_load"].numpy(), np.asarray(mj["moe_load"])
        assert load_t.sum() == load_j.sum() == valid.sum() * 4 * jm.cfg.n_layers
        assert np.abs(load_t - load_j).sum() <= load_j.sum() // 4
        want_states = router_states_from_numpy(jax.device_get(js), jm.cfg)
        np.testing.assert_allclose(ts[0]["q"].numpy(), want_states[0]["q"].numpy(), atol=1e-6)
        for got, want in zip(ts, want_states):
            np.testing.assert_allclose(got["q"].numpy(), want["q"].numpy(), atol=0.05)
        assert np.isfinite(lt.numpy()).all()


def test_decode_step_topk():
    """Unmasked decode steps (no lengths): logits allclose over 3 tokens."""
    jm, jp, tm, tp = _strategy_models("topk")
    jc, js = jm.init_slot_cache(jp, 2, 8), jm.init_router_states()
    tc, ts = tm.init_slot_cache(tp, 2, 8), tm.init_router_states()
    rng = np.random.default_rng(6)
    for _ in range(3):
        tok = rng.integers(0, 128, (2, 1)).astype(np.int32)
        lj, jc, js = jm.decode_step(jp, jnp.asarray(tok), jc, js)
        lt, tc, ts = tm.decode_step(tp, _t(tok).long(), tc, ts)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)


def test_prefill_with_norm_and_softcap_knobs():
    """The ported gemma2-style branches — qk_norm, post-block norms, attention
    and final logit softcaps — on one ragged chunk, top-k routing."""
    knobs = dict(qk_norm=True, post_block_norms=True, attn_logit_softcap=5.0, final_logit_softcap=3.0)
    jcfg, tcfg = _cfgs(**knobs)
    jcfg = dataclasses.replace(jcfg, routing=dataclasses.replace(jcfg.routing, strategy="topk"))
    tcfg = dataclasses.replace(tcfg, routing=dataclasses.replace(tcfg.routing, strategy="topk"))
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tm, tp = Model(tcfg, device="cpu"), params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    tokens = np.random.default_rng(8).integers(0, 128, (2, 8)).astype(np.int32)
    lengths = np.array([8, 3], np.int32)
    lj, _, _, mj = jm.prefill_chunk(jp, jnp.asarray(tokens), jm.init_slot_cache(jp, 2, 16),
                                    jm.init_router_states(), jnp.asarray(lengths))
    lt, _, _, mt = tm.prefill_chunk(tp, _t(tokens).long(), tm.init_slot_cache(tp, 2, 16),
                                    tm.init_router_states(), _t(lengths).long())
    valid = np.arange(8)[None, :] < lengths[:, None]
    np.testing.assert_allclose(lt.numpy()[valid], np.asarray(lj)[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mt["moe_load"].numpy(), np.asarray(mj["moe_load"]))


def test_reset_slot_zeroes_one_row(models):
    _, _, tm, tp = models
    cache = tm.init_slot_cache(tp, 3, 16)
    for layer in cache["layers"]:
        for leaf in layer.values():
            leaf.fill_(1)
    tm.reset_slot(cache, 1)
    for layer in cache["layers"]:
        for leaf in layer.values():
            assert bool((leaf[1] == 0).all()) and bool((leaf[0] == 1).all())


def test_npz_checkpoint_loads(models, tmp_path):
    from repro.checkpoint import save_pytree

    jm, jp, tm, tp = models
    path = str(tmp_path / "params.npz")
    save_pytree(path, {"params": jp, "step": jnp.asarray(3)})
    loaded = load_npz_params(path, tm.cfg, "cpu")
    flat_a = jax.tree_util.tree_leaves(loaded)
    flat_b = jax.tree_util.tree_leaves(tp)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert torch.equal(a, b)
    # bf16 leaves travel as uint16 bit patterns
    bpath = str(tmp_path / "bf16.npz")
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    save_pytree(bpath, {"w": jnp.asarray(x, jnp.bfloat16), "t": (jnp.ones(2),), "n": None})
    tree = load_npz_tree(bpath)
    assert tree["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["w"].float().numpy(), np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    assert tree["n"] is None and tree["t"][0].tolist() == [1.0, 1.0]
