"""Port vs reference: the ten assigned architectures (mamba2 SSD, the zamba2
shared block, encoder-decoder, the vlm prefix, dense-residual MoE, iRoPE
MoE, local/global attention with softcaps, plain dense decoders).

Each architecture runs at the reference's `reduced_for_smoke` size with
fp32 compute. Parameters come from the reference's `Model.init` through
`convert.params_from_numpy`; tokens, patches and frames are drawn with
numpy. MoE architectures route with `topk` (score-deterministic, so
routing is bitwise the same); one llama4 case routes with `bip`, held to
the degeneracy contract of ROADMAP.md queue 3. The JAX functions are
jitted and every result is computed once per architecture (module-level
caches), so the file stays light.

Tolerances: forward aux and per-layer metrics 1e-5 (rtol and atol),
logits rtol 1e-5 / atol 2e-5 (the hybrid zamba2, two shared-block uses over
four reduced layers, reaches 1.3e-5 on logits of magnitude ~4 from fp32
reassociation; the others stay under 6e-6); loss 1e-5 and every gradient rtol 1e-4 / atol 1e-5 (a gradient
sums over every position, so its fp32 order differs more between XLA and
torch); chunked prefill and decode logits and caches 1e-4, as the port's
other serving parity tests; greedy tokens and integer metrics exact. In
bf16 compute (mamba2, zamba2) the port's chunked-serving-vs-forward gap is
held within 1.5x the reference's own gap plus 1e-4.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data import make_batches as jax_make_batches  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import greedy_generate as jax_greedy_generate  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import decay_mask, params_from_numpy, params_to_tree, unstack_blocks  # noqa: E402
from repro_torch.data import frontend_stubs  # noqa: E402
from repro_torch.models import Model, common, stack  # noqa: E402
from repro_torch.optim.adamw import tree_paths  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402

ARCHS = [a for a in configs.ARCH_IDS if not a.startswith("minimind")]
B, S = 2, 12
FWD = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
SERVE = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree (None leaves dropped)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{prefix}.{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{prefix}[{i}]").items()}
    return {} if tree is None else {prefix: tree}


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _cfgs(arch, strategy="topk", **kw):
    jcfg, tcfg = jax_configs.reduced_for_smoke(arch, **kw), configs.reduced_for_smoke(arch, **kw)
    if jcfg.is_moe:
        jcfg = dataclasses.replace(jcfg, routing=dataclasses.replace(jcfg.routing, strategy=strategy))
        tcfg = dataclasses.replace(tcfg, routing=dataclasses.replace(tcfg.routing, strategy=strategy))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _built(arch, strategy="topk", tie=True):
    jcfg, tcfg = _cfgs(arch, strategy, **({} if tie else {"tie_embeddings": False}))
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, Model(tcfg, device="cpu"), params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def _batch(cfg, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
    }
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((batch, cfg.enc_seq_len, cfg.frontend_dim)).astype(np.float32)
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _both_fwd_grad(arch, strategy="topk", tie=True):
    """(reference, port) results of one forward and one loss gradient on
    the same batch: logits, aux, forward metrics, loss, grads (reference
    layout), new router states."""
    jm, jp, tm, tp = _built(arch, strategy, tie)
    b = _batch(jm.cfg)

    def jax_fn(params, batch, states):
        (loss, _), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(params, batch, states)
        logits, new_states, aux, mets = jm.forward(params, batch, states)
        return logits, aux, mets, loss, grads, new_states

    ref = jax.device_get(jax.jit(jax_fn)(jp, _jax_batch(b), jm.init_router_states()))
    leaves = [leaf for _, leaf in tree_paths(tp)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = _torch_batch(b)
    logits, new_states, aux, mets = tm.forward(tp, tb, tm.init_router_states())
    loss, _ = tm.loss_fn(tp, tb, tm.init_router_states())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    grad_tree = _unflatten(tp, dict(zip([p for p, _ in tree_paths(tp)], grads)))
    port = (logits.detach(), aux.detach(), {k: v.detach() for k, v in mets.items()}, loss.detach(),
            params_to_tree(grad_tree, tm.cfg), new_states)
    return ref, port


def _unflatten(tree, by_path, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, by_path, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, by_path, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return by_path[prefix]


# --------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """The port's full config equals the reference's field by field (dtypes
    mapped by name; the port's RoutingSpec has one field of its own)."""
    jcfg, tcfg = jax_configs.get(arch), configs.get(arch)

    def same(a, b):
        if dataclasses.is_dataclass(a):
            return all(same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
        if hasattr(a, "dtype") or type(a).__name__ in ("type", "_ScalarMeta"):
            return np.dtype(a).name == str(b).removeprefix("torch.")
        return a == b

    for f in dataclasses.fields(jcfg):
        assert same(getattr(jcfg, f.name), getattr(tcfg, f.name)), (arch, f.name)
    assert configs.get(arch.replace("_", "-").replace("3-8b", "3.8b").replace("1-6b", "1.6b")) is tcfg
    stack.check_supported(tcfg)


def test_registry_matches_reference():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.CLI_ALIASES == jax_configs.CLI_ALIASES
    assert set(configs.all_configs()) == set(jax_configs.ARCH_IDS)
    for cfg in configs.all_configs().values():
        stack.check_supported(cfg)  # raises for no configuration


# --------------------------------------------------------------- forward


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    (rl, raux, rmets, *_), (tl, taux, tmets, *_) = _both_fwd_grad(arch)
    np.testing.assert_allclose(tl.numpy(), rl, **LOGITS)
    np.testing.assert_allclose(float(taux), float(raux), **FWD)
    assert set(tmets) == set(rmets), (sorted(tmets), sorted(rmets))
    for k in tmets:
        if np.issubdtype(np.asarray(rmets[k]).dtype, np.integer):
            np.testing.assert_array_equal(tmets[k].numpy(), rmets[k], err_msg=k)
        else:
            np.testing.assert_allclose(_np(tmets[k]), rmets[k], err_msg=k, **FWD)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    (*_, rloss, rgrads, _), (*_, tloss, tgrads, _) = _both_fwd_grad(arch)
    np.testing.assert_allclose(float(tloss), float(rloss), **FWD)
    want, got = _flat(rgrads), _flat(tgrads)
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(_np(got[path]), g, err_msg=path, **GRAD)
    assert float(np.abs(want[".embed.tok"]).sum()) > 0


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mamba2_130m"])
def test_untied_embeddings_match_reference(arch):
    """No reference config unties its head: `tie_embeddings=False` adds
    embed.unembed (d, vocab) on both sides."""
    (rl, _, _, rloss, rgrads, _), (tl, _, _, tloss, tgrads, _) = _both_fwd_grad(arch, tie=False)
    assert tuple(_built(arch, tie=False)[3]["embed"]["unembed"].shape) == (128, 512)
    np.testing.assert_allclose(tl.numpy(), rl, **LOGITS)
    np.testing.assert_allclose(float(tloss), float(rloss), **FWD)
    for path, g in _flat(rgrads).items():
        np.testing.assert_allclose(_np(_flat(tgrads)[path]), g, err_msg=path, **GRAD)


def test_llama4_bip_forward_within_contract():
    """bip routing on llama4 (top-1, 4 experts reduced): the first MoE
    layer's dual allclose at 1e-6, every dual within 0.05, each layer's
    load total exact and per-expert loads within an L1 distance of a
    quarter of it (the port's BIP contract, DESIGN.md §"What parity means
    under degeneracy"), logits finite."""
    jm, jp, tm, tp = _built("llama4_scout_17b_a16e", "bip")
    b = _batch(jm.cfg)
    _, rstates, _, rmets = jax.device_get(jax.jit(jm.forward)(jp, _jax_batch(b), jm.init_router_states()))
    tl, tstates, _, tmets = tm.forward(tp, _torch_batch(b), tm.init_router_states())
    want = unstack_blocks(list(rstates), jm.cfg)
    np.testing.assert_allclose(tstates[0]["q"].numpy(), want[0]["q"], atol=1e-6)
    for got, w in zip(tstates, want):
        np.testing.assert_allclose(got["q"].numpy(), w["q"], atol=0.05)
    lt, lj = tmets["load_per_layer"].numpy(), np.asarray(rmets["load_per_layer"])
    np.testing.assert_array_equal(lt.sum(-1), lj.sum(-1))
    assert (np.abs(lt - lj).sum(-1) <= lj.sum(-1) // 4).all()
    assert np.isfinite(tl.numpy()).all()


# --------------------------------------------------------------- serving


def _prefill_inputs(jm, jp, tm, tp, b):
    """Both packages' caches: the slot cache, or for encdec the per-request
    cache with the encoder's cross K/V."""
    if jm.cfg.n_enc_layers:
        jb = {"tokens": jnp.asarray(b["tokens"]), "frames": jnp.asarray(b["frames"])}
        tb = {"tokens": _t(b["tokens"]).long(), "frames": _t(b["frames"])}
        return jm.init_cache(jp, jb, 32), tm.init_cache(tp, tb, 32)
    return jm.init_slot_cache(jp, B, 32), tm.init_slot_cache(tp, B, 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_then_decode_matches_reference(arch):
    """Two prefill chunks with mixed lengths, then one decode step: valid
    logits, the router's load and every cache leaf (K/V, positions, SSM and
    conv state, the shared block's K/V, cross K/V)."""
    jm, jp, tm, tp = _built(arch)
    b = _batch(jm.cfg, seed=1)
    jc, tc = _prefill_inputs(jm, jp, tm, tp, b)
    js, ts = jm.init_router_states(), tm.init_router_states()
    prefill, decode = jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step)
    rng = np.random.default_rng(2)
    for c, lens in ((6, [6, 3]), (6, [4, 6]), (1, None)):
        tok = rng.integers(0, jm.cfg.vocab_size, (B, c)).astype(np.int32)
        if lens is None:
            lj, jc, js = decode(jp, jnp.asarray(tok), jc, js)
            lt, tc, ts = tm.decode_step(tp, _t(tok).long(), tc, ts)
            valid = np.ones((B, c), bool)
        else:
            lengths = np.asarray(lens, np.int32)
            lj, jc, js, mj = prefill(jp, jnp.asarray(tok), jc, js, jnp.asarray(lengths))
            lt, tc, ts, mt = tm.prefill_chunk(tp, _t(tok).long(), tc, ts, _t(lengths).long())
            np.testing.assert_array_equal(mt["moe_load"].numpy(), np.asarray(mj["moe_load"]))
            valid = np.arange(c)[None, :] < lengths[:, None]
        np.testing.assert_allclose(lt.numpy()[valid], np.asarray(lj)[valid], **SERVE)
    want = unstack_blocks(jax.device_get(jc["blocks"]), jm.cfg)
    assert len(want) == len(tc["layers"])
    for i, (got, w) in enumerate(zip(tc["layers"], want)):
        assert set(got) == set(w), (i, sorted(got), sorted(w))
        for k in w:
            np.testing.assert_allclose(_np(got[k]), np.asarray(w[k], np.float32), err_msg=f"layer {i} {k}",
                                       **SERVE)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    """Token for token: the engine path for the token families, the
    per-token path for seamless (frames) and paligemma (patches)."""
    jm, jp, tm, tp = _built(arch)
    b = _batch(jm.cfg, seed=3, seq=5)
    extra = {k: b[k] for k in ("frames", "patches") if k in b} or None
    want = jax_greedy_generate(jm, jp, jnp.asarray(b["tokens"]), 4, max_seq_len=32,
                               extra_batch=None if extra is None else _jax_batch(extra))
    got = greedy_generate(tm, tp, b["tokens"], 4, max_seq_len=32,
                          extra_batch=None if extra is None else _torch_batch(extra))
    assert got.dtype == torch.int64 and tuple(got.shape) == (B, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


GAP_SEQ, GAP_SPLIT = 48, (20, 13)  # rows split after 20 / 13 tokens, then the rest, then decode


def _served_logits(prefill, decode, params, cache, states, toks, as_input, to_np):
    """Teacher-forced serving of `toks` (2, GAP_SEQ): prefill_chunk in two
    chunks of unequal lengths per row, then decode_step on the last token."""
    out = np.zeros(toks.shape + (0,), np.float32)
    lo = [0, 0]
    for widths in (GAP_SPLIT, tuple(GAP_SEQ - 1 - w for w in GAP_SPLIT)):
        chunk = np.zeros((2, max(widths)), np.int32)
        for r in range(2):
            chunk[r, :widths[r]] = toks[r, lo[r]:lo[r] + widths[r]]
        logits, cache, states, _ = prefill(params, as_input(chunk), cache, states,
                                           as_input(np.asarray(widths, np.int32)))
        logits = to_np(logits)
        if not out.shape[-1]:
            out = np.zeros(toks.shape + logits.shape[-1:], np.float32)
        for r in range(2):
            out[r, lo[r]:lo[r] + widths[r]] = logits[r, :widths[r]]
            lo[r] += widths[r]
    out[:, -1] = to_np(decode(params, as_input(toks[:, -1:]), cache, states)[0])[:, 0]
    return out


@pytest.mark.parametrize("arch,n_layers", [("mamba2_130m", None), ("zamba2_7b", 12)])
def test_bf16_serving_gap_within_reference(arch, n_layers):
    """In bf16 compute the chunked serving path and the whole-sequence
    forward round apart. The port's gap (relative Frobenius error of the
    served logits against forward's, over all positions) stays within 1.5x
    the reference's own gap on the same params and tokens, plus 1e-4: a
    bf16 cast that the reference does not make on one path (a state or
    cache rounded to bf16, say) widens the port's gap past the reference's,
    which the fp32 tests cannot see. zamba2 runs 12 reduced layers (six
    shared-block uses), deeper than its reduced 4, because the gap grows
    with depth."""
    over = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = jax_configs.reduced_for_smoke(arch, compute_dtype=jnp.bfloat16, **over)
    tcfg = configs.reduced_for_smoke(arch, compute_dtype=torch.bfloat16, **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm, tp = Model(tcfg, device="cpu"), params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, GAP_SEQ)).astype(np.int32)

    jfwd = np.asarray(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)}, jm.init_router_states())[0],
                      np.float32)
    jserved = _served_logits(jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step), jp,
                             jm.init_slot_cache(jp, 2, 256), jm.init_router_states(), toks, jnp.asarray,
                             lambda a: np.asarray(a, np.float32))
    with torch.no_grad():
        tfwd = tm.forward(tp, {"tokens": _t(toks).long()}, tm.init_router_states())[0].float().numpy()
        tserved = _served_logits(tm.prefill_chunk, tm.decode_step, tp, tm.init_slot_cache(tp, 2, 256),
                                 tm.init_router_states(), toks, lambda a: _t(a).long(),
                                 lambda a: a.float().numpy())
    assert np.isfinite(tserved).all()
    ref_gap = float(np.linalg.norm(jserved - jfwd) / np.linalg.norm(jfwd))
    port_gap = float(np.linalg.norm(tserved - tfwd) / np.linalg.norm(tfwd))
    assert port_gap <= 1.5 * ref_gap + 1e-4, (port_gap, ref_gap)


def test_slot_cache_refuses_encdec_and_packed_prefill():
    jm, jp, tm, tp = _built("seamless_m4t_large_v2")
    with pytest.raises(ValueError, match="encdec"):
        tm.init_slot_cache(tp, 2, 16)
    from repro_torch.serving import ContinuousBatchingEngine

    with pytest.raises(ValueError, match="encdec"):
        ContinuousBatchingEngine(tm, tp, n_slots=2, chunk_size=4, max_seq_len=16)
    tok = torch.zeros((2, 4), dtype=torch.int64)
    for arch in ("mamba2_130m", "zamba2_7b"):  # packed operands need an attention-only stack
        _, _, tz, pz = _built(arch)
        with pytest.raises(ValueError, match="attention-only"):
            tz.prefill_chunk(pz, tok, tz.init_slot_cache(pz, 2, 16), tz.init_router_states(),
                             positions=tok, segments=tok, write_slots=tok, cache_rows=torch.arange(2))
    with pytest.raises(ValueError, match="mamba recurrence"):
        tz.forward(pz, {"tokens": tok, "segments": torch.zeros_like(tok)}, tz.init_router_states())


def test_reset_slot_zeroes_mamba_and_shared_leaves():
    _, _, tm, tp = _built("zamba2_7b")
    cache = tm.init_slot_cache(tp, 3, 16)
    assert {"ssm", "conv", "sk", "sv", "spos"} <= set().union(*map(set, cache["layers"]))
    for layer in cache["layers"]:
        for leaf in layer.values():
            leaf.fill_(1)
    tm.reset_slot(cache, 1)
    for layer in cache["layers"]:
        for leaf in layer.values():
            assert bool((leaf[1] == 0).all()) and bool((leaf[0] == 1).all())


# --------------------------------------------------------------- params


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bitwise(arch):
    """params_from_numpy and params_to_tree invert each other leaf for leaf
    (stack.shared, encoder layers, frontend_proj included)."""
    jm, jp, tm, tp = _built(arch)
    want = _flat(jax.device_get(jp))
    tree = params_to_tree(tp, tm.cfg)
    got = _flat(tree)
    assert set(got) == set(want)
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        np.testing.assert_array_equal(_np(got[path]), np.asarray(a, np.float32), err_msg=path)
    again = params_from_numpy(tree, tm.cfg)
    for (pa, a), (pb, b2) in zip(tree_paths(tp), tree_paths(again)):
        assert pa == pb and a.dtype == b2.dtype and torch.equal(a, b2)
    # the port's own init has the same leaves, shapes and dtypes
    fresh = {p: x for p, x in tree_paths(tm.init(0))}
    assert {p: (tuple(x.shape), x.dtype) for p, x in fresh.items()} == \
        {p: (tuple(x.shape), x.dtype) for p, x in tree_paths(tp)}


@pytest.mark.parametrize("arch", ["zamba2_7b", "seamless_m4t_large_v2", "arctic_480b"])
def test_npz_checkpoint_carries_the_new_leaves(arch, tmp_path):
    """A reference npz (repro.checkpoint.save_pytree) loads into the port's
    layout bit for bit: stack.shared, encoder layers and frontend_proj,
    dense-residual MoE leaves."""
    from repro.checkpoint import save_pytree
    from repro_torch.convert import load_npz_params

    jm, jp, tm, tp = _built(arch)
    path = str(tmp_path / "params.npz")
    save_pytree(path, {"params": jp, "step": jnp.asarray(1)})
    loaded = load_npz_params(path, tm.cfg)
    got, want = tree_paths(loaded), tree_paths(tp)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path_


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_follows_reference_layout(arch):
    """decay_mask equals the reference's `ndim >= 2` rule applied in ITS
    layout (decoder blocks and encoder layers stacked, stack.shared not)."""
    jm, jp, tm, tp = _built(arch)
    ndims = jax.tree.map(lambda a: np.full(a.shape, a.ndim, np.int8), jax.device_get(jp))
    by_path = dict(tree_paths(params_from_numpy(ndims, tm.cfg)))
    mask = decay_mask(tp)
    assert set(mask) == set(by_path)
    for path, nd in by_path.items():
        assert mask[path] == (int(nd.flatten()[0]) >= 2), path
    if arch == "zamba2_7b":
        assert not mask["stack.shared.pre_norm.scale"] and mask["stack.shared.mlp.w_gate"]
        assert mask["stack.layers[0].mamba.A_log"]
    if arch == "seamless_m4t_large_v2":
        assert mask["encoder.layers[0].pre_norm.scale"] and not mask["encoder.final_norm.scale"]


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_frontend_stubs_match_reference(family):
    arch = {"vlm": "paligemma_3b", "encdec": "seamless_m4t_large_v2"}[family]
    jcfg, tcfg = _cfgs(arch)
    key = {"vlm": "patches", "encdec": "frames"}[family]
    want = next(jax_make_batches(jcfg, 2, 8, 1, seed=4))[key]
    from repro_torch.data import make_batches

    got = next(make_batches(tcfg, 2, 8, 1, seed=4))
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want))
    np.testing.assert_array_equal(frontend_stubs(tcfg, 2, seed=4)[key].numpy(), np.asarray(want))
    assert frontend_stubs(configs.reduced_for_smoke("stablelm_1_6b"), 2) == {}


# --------------------------------------------------------------- init


def test_randn_leaf_under_threshold_is_unchanged():
    """A leaf of at most SLICE_NUMEL elements is the old formula bit for bit
    (minimind's weights, and so the balance numbers, do not move)."""
    for dtype in (torch.float32, torch.bfloat16):
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        got = common._randn(g1, (64, 48), 0.3, dtype)
        want = (torch.randn((64, 48), generator=g2) * 0.3).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(torch.randn(3, generator=g1), torch.randn(3, generator=g2))


def test_randn_large_leaf_is_drawn_in_slices(monkeypatch):
    """Over the threshold the leaf is written block by block along its
    leading axis in the param dtype: seeded, reproducible, N(0, scale²)."""
    monkeypatch.setattr(common, "SLICE_NUMEL", 1000)
    monkeypatch.setattr(common, "_BLOCK_NUMEL", 600)
    shape = (40, 20, 10)  # 8000 elements: 3 rows (600 elements) per block
    a = common._randn(torch.Generator().manual_seed(1), shape, 0.5, torch.bfloat16)
    b = common._randn(torch.Generator().manual_seed(1), shape, 0.5, torch.bfloat16)
    c = common._randn(torch.Generator().manual_seed(2), shape, 0.5, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == shape
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.float().std()) - 0.5) < 0.02 and abs(float(a.float().mean())) < 0.02
    # each block is its own draw, so not the numbers of a whole draw
    whole = (torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 0.5).to(torch.bfloat16)
    assert not torch.equal(a, whole)


def test_serve_cli_every_family_on_cpu(capsys):
    from repro_torch.launch import serve

    for arch in ("zamba2-7b", "paligemma-3b", "arctic-480b"):
        rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                         "--n-slots", "2", "--chunk", "4", "--gen", "2", "--prompt-len", "5"])
        assert rc == 0
        assert "served 2 requests over 2 slots" in capsys.readouterr().out
    with pytest.raises(ValueError, match="encdec"):
        serve.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--device", "cpu"])
