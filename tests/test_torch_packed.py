"""Port vs reference: packed multi-request serving prefill.

The packed layout decouples batch rows from cache slots: every column of
the (rows, chunk) grid carries its absolute position, its segment (0 = the
row's resident stream, >= 1 a fresh prompt sharing the row, -1 padding) and
the cache row it writes; each grid row reads the cache row `cache_rows`
names, so a spread row continues another slot's stream. Held here, at
reduced size in fp32, on the same seeded inputs and converted weights:

1. `common._attention_chunk_packed` against the reference's, on a global
   and on a ring (local) layer;
2. `Model.prefill_chunk` in packed form against the reference's, two
   consecutive steps, stablelm / gemma2 / minimind-moe-16e (top-k, bip);
3. packed against sequential prefill inside the port (the reference's
   contract, within 1e-5: the reference's own bitwise form of this test
   fails on its tree, see ROADMAP.md "Reference caveats");
4. the engine's planner and token streams against the reference engine's,
   and fewer steps than the one-row-per-slot schedule;
5. padding hygiene: poisoned padded columns change no token.
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
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy, router_states_from_numpy, unstack_blocks  # noqa: E402
from repro_torch.models import Model, common  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402

VOCAB = 128
ATTN = dict(rtol=1e-5, atol=1e-6)
LOGITS = dict(rtol=1e-5, atol=1e-5)
WINDOW = 12  # gemma2's ring, cut so that a 32-token cache wraps it


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, strategy=None, **routing):
    """Reduced configs of both packages; minimind with the full 16e / top-4
    table (as the engine tests run it), `strategy` and `routing` fields."""
    kw = {"vocab_size": VOCAB}
    if arch == "gemma2_27b":
        kw["window_size"] = WINDOW
    if arch.startswith("minimind"):
        jfull, tfull = jax_configs.get(arch), configs.get(arch)
        kw_j = dict(kw, routing=dataclasses.replace(jfull.routing, strategy=strategy, **routing))
        kw_t = dict(kw, routing=dataclasses.replace(tfull.routing, strategy=strategy, **routing))
        return jax_configs.reduced_for_smoke(arch, **kw_j), configs.reduced_for_smoke(arch, **kw_t)
    return jax_configs.reduced_for_smoke(arch, **kw), configs.reduced_for_smoke(arch, **kw)


@functools.lru_cache(maxsize=None)
def _built(arch, strategy=None, **routing):
    jcfg, tcfg = _cfgs(arch, strategy, **routing)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, Model(tcfg, device="cpu"), params_from_numpy(jax.device_get(jp), tcfg, "cpu")


class Grid:
    """Packed operands of one (rows, chunk) step, built column run by run;
    unplaced columns are padding with a poisoned position."""

    def __init__(self, rows, chunk, rng):
        self.tokens = rng.integers(0, VOCAB, (rows, chunk)).astype(np.int32)
        self.positions = np.full((rows, chunk), 7, np.int32)
        self.segments = np.full((rows, chunk), -1, np.int32)
        self.write_slots = np.full((rows, chunk), -1, np.int32)
        self.cache_rows = np.arange(rows, dtype=np.int32)

    def put(self, row, col, pos0, n, seg, slot, reads=None):
        self.positions[row, col:col + n] = np.arange(pos0, pos0 + n)
        self.segments[row, col:col + n] = seg
        self.write_slots[row, col:col + n] = slot
        if reads is not None:
            self.cache_rows[row] = reads
        return self

    def operands(self, conv):
        return {k: conv(getattr(self, k)) for k in ("positions", "segments", "write_slots", "cache_rows")}


# ---------------------------------------------------- 1. attention layer


@pytest.mark.parametrize("arch,kind,cap", [("stablelm_1_6b", "global", 20), ("gemma2_27b", "local", WINDOW)])
def test_attention_chunk_packed_matches_reference(arch, kind, cap):
    """Every kind of column on one layer: a resident decode row; a resident
    stream row and a spread row continuing it (cache_rows[2] = 1), on the
    global layer past the cache's end (written nowhere, still counted), on
    the ring up to its length (a longer stream would write one ring slot
    twice, which neither package orders);
    two fresh segments sharing a row; a real column with write_slots = -1;
    padding with poisoned positions. Outputs on real columns, every cache
    row and pos against the reference."""
    jm, jp, _, _ = _built(arch)
    jcfg, tcfg = _cfgs(arch)
    j = [k for k, _ in jcfg.layer_kinds()].index(kind)
    attn_j = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"][j]["attn"])
    attn_t = {k: _t(v) for k, v in jax.device_get(attn_j).items()}
    rng = np.random.default_rng(0)
    rows, c, n_rows = 4, 8, 6
    kv, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim
    x = rng.standard_normal((rows, c, jcfg.d_model)).astype(np.float32)
    k = rng.standard_normal((n_rows, cap, kv, hd)).astype(np.float32)
    v = rng.standard_normal((n_rows, cap, kv, hd)).astype(np.float32)
    pos = np.array([5, 8, 0, 0, 0, 0], np.int32)
    g = Grid(rows, c, rng).put(0, 0, 5, 1, 0, 0)  # decode of slot 0
    g.put(1, 0, 8, 8, 0, 1)  # slot 1's stream, resident
    g.put(2, 0, 16, 6 if kind == "global" else 4, 0, 1, reads=1)  # spread: continues slot 1
    g.put(3, 0, 0, 3, 1, 3).put(3, 3, 0, 5, 2, 4)  # two fresh prompts share row 3
    g.write_slots[3, 7] = -1  # real, but dropped: written nowhere, not counted
    oj, cj = jax_common._attention_chunk_packed(
        attn_j, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)},
        jcfg, layer_kind=kind, **g.operands(jnp.asarray),
    )
    ot, ct = common._attention_chunk_packed(
        attn_t, _t(x), {"k": _t(k), "v": _t(v), "pos": _t(pos).long()},
        tcfg, layer_kind=kind, **g.operands(lambda a: _t(a).long()),
    )
    valid = g.segments >= 0
    np.testing.assert_allclose(ot.numpy()[valid], np.asarray(oj)[valid], **ATTN)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), **ATTN)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    if kind == "global":  # 16..21 went to slot 1: 20 and 21 are past the cache, counted all the same
        assert ct["pos"].tolist() == [6, 22, 0, 3, 4, 0]


# ------------------------------------------------------ 2. prefill_chunk


def _steps(spread, rng):
    """Two packed steps over 4 slots x chunk 8: slot 0's prompt as a
    resident stream (spread over row 1 on the all-global stacks), two fresh
    prompts sharing row 2, then their decodes beside the stream."""
    s1 = Grid(4, 8, rng).put(0, 0, 0, 8, 0, 0)
    s1.put(2, 0, 0, 3, 1, 2).put(2, 3, 0, 4, 2, 3)
    s2 = Grid(4, 8, rng).put(2, 0, 3, 1, 0, 2).put(3, 0, 4, 1, 0, 3)
    if spread:
        s1.put(1, 0, 8, 6, 0, 0, reads=0)
        s2.put(0, 0, 14, 8, 0, 0).put(1, 0, 22, 6, 0, 0, reads=0)
    else:
        s2.put(0, 0, 8, 8, 0, 0)
    return s1, s2


def _port_cache(jm, jc):
    layers = unstack_blocks(jax.device_get(jc["blocks"]), jm.cfg)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in layers]


@pytest.mark.parametrize("arch,strategy", [("stablelm_1_6b", None), ("gemma2_27b", None),
                                           ("minimind_moe_16e", "topk"), ("minimind_moe_16e", "bip")])
def test_packed_prefill_chunk_matches_reference(arch, strategy):
    """Two packed steps of the whole model: logits on real columns and
    every cache leaf within 1e-5 (K/V past layer 0 carry the earlier
    layers' fp32 rounding), and (top-k) the MoE load, bitwise, against the
    reference. Under bip
    each step starts from the reference's cache and duals and is held to
    the degeneracy contract (test_torch_model.py): the first MoE layer's q
    within 1e-6, every layer's within 0.05, the load total exact and its
    per-expert L1 gap within a quarter of it, MaxVio within one token."""
    jm, jp, tm, tp = _built(arch, strategy)
    rng = np.random.default_rng(1)
    jc, js = jm.init_slot_cache(jp, 4, 32), jm.init_router_states()
    tc, ts = tm.init_slot_cache(tp, 4, 32), tm.init_router_states()
    for step, g in enumerate(_steps(arch != "gemma2_27b", rng)):
        if strategy == "bip":  # teacher-forced in state
            tc = {"layers": [{k: _t(v) for k, v in layer.items()} for layer in _port_cache(jm, jc)]}
            for layer in tc["layers"]:
                layer["pos"] = layer["pos"].long()
            ts = router_states_from_numpy(jax.device_get(js), jm.cfg)
        lj, jc, js, mj = jm.prefill_chunk(jp, jnp.asarray(g.tokens), jc, js, **g.operands(jnp.asarray))
        with torch.no_grad():
            lt, tc, ts, mt = tm.prefill_chunk(tp, _t(g.tokens).long(), tc, ts,
                                              **g.operands(lambda a: _t(a).long()))
        valid = g.segments >= 0
        load_t, load_j = mt["moe_load"].numpy(), np.asarray(mj["moe_load"])
        if strategy == "bip":
            if step == 0:
                np.testing.assert_allclose(lt.numpy()[valid], np.asarray(lj)[valid], **LOGITS)
            assert load_t.sum() == load_j.sum() == valid.sum() * 4 * jm.cfg.n_layers
            assert np.abs(load_t - load_j).sum() <= load_j.sum() // 4
            mean = load_j.sum() / jm.cfg.n_layers / 16  # tokens per expert in one layer
            assert abs(float(mt["max_vio"]) - float(mj["max_vio"])) <= 1.0 / mean + 1e-6
            want = router_states_from_numpy(jax.device_get(js), jm.cfg)
            np.testing.assert_allclose(ts[0]["q"].numpy(), want[0]["q"].numpy(), atol=1e-6)
            for got, w in zip(ts, want):
                np.testing.assert_allclose(got["q"].numpy(), w["q"].numpy(), atol=0.05)
            assert np.isfinite(lt.numpy()).all()
            continue
        np.testing.assert_allclose(lt.numpy()[valid], np.asarray(lj)[valid], **LOGITS)
        np.testing.assert_array_equal(load_t, load_j)
        for i, (got, want) in enumerate(zip(tc["layers"], _port_cache(jm, jc))):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=f"layer {i}", **LOGITS)
            np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])


# ------------------------------------------------ 3. packed vs sequential


def _seq_prefill(tm, tp, prompt, slot, n_slots, c, cache, st):
    toks = torch.zeros((n_slots, c), dtype=torch.int64)
    toks[slot, : len(prompt)] = torch.as_tensor(prompt)
    lengths = torch.zeros((n_slots,), dtype=torch.int64)
    lengths[slot] = len(prompt)
    lg, cache, st, _ = tm.prefill_chunk(tp, toks, cache, st, lengths)
    return lg[slot, len(prompt) - 1], cache, st


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "gemma2_27b"])
@torch.no_grad()
def test_packed_prefill_matches_sequential(arch):
    """The reference's contract within 1e-5: a resident decode in row 0 and
    two fresh prompts as segments of row 1 give the logits and cache rows
    of prefilling each prompt alone, then the decode."""
    _, _, tm, tp = _built(arch)
    rng = np.random.default_rng(0)
    n_slots, c, seq_len = 4, 8, 32
    p0, p1, p2 = (rng.integers(0, VOCAB, (n,)) for n in (5, 3, 4))

    st, cache = tm.init_router_states(), tm.init_slot_cache(tp, n_slots, seq_len)
    lg0, cache, st = _seq_prefill(tm, tp, p0, 0, n_slots, c, cache, st)
    lg1, cache, st = _seq_prefill(tm, tp, p1, 1, n_slots, c, cache, st)
    lg2, cache, st = _seq_prefill(tm, tp, p2, 2, n_slots, c, cache, st)
    tok0 = int(torch.argmax(lg0))
    toks = torch.zeros((n_slots, c), dtype=torch.int64)
    toks[0, 0] = tok0
    lengths = torch.tensor([1, 0, 0, 0])
    lg_dec, cache_ref, _, _ = tm.prefill_chunk(tp, toks, cache, st, lengths)

    st, cache = tm.init_router_states(), tm.init_slot_cache(tp, n_slots, seq_len)
    _, cache, st = _seq_prefill(tm, tp, p0, 0, n_slots, c, cache, st)
    g = Grid(n_slots, c, rng).put(0, 0, len(p0), 1, 0, 0).put(1, 0, 0, 3, 1, 1).put(1, 3, 0, 4, 2, 2)
    g.tokens[0, 0] = tok0
    g.tokens[1, :7] = np.concatenate([p1, p2])
    lg, cache_got, _, _ = tm.prefill_chunk(tp, _t(g.tokens).long(), cache, st,
                                           **g.operands(lambda a: _t(a).long()))
    for got, want in ((lg[0, 0], lg_dec[0, 0]), (lg[1, 2], lg1), (lg[1, 6], lg2)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGITS)
    for a, b in zip(cache_ref["layers"], cache_got["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(b[key][:3].numpy(), a[key][:3].numpy(), **LOGITS)
        np.testing.assert_array_equal(b["pos"][:3].numpy(), a["pos"][:3].numpy())


# ----------------------------------------------------------- 4-5. engine


def _record_plans(eng):
    """Wrap the engine's planner: every step's operand arrays (or None)."""
    plans, orig = [], eng._plan_packed

    def wrapped(active):
        out = orig(active)
        plans.append(None if out is None else [np.asarray(a) for a in out[:-1]])
        return out

    eng._plan_packed = wrapped
    return plans


def _run_stream(eng, prompts, gen=6):
    reqs = [eng.submit(p, gen, ignore_eos=True) for p in prompts]
    assert all(r is not None for r in reqs)
    steps = 0
    while eng.scheduler.has_work:
        eng.step()
        steps += 1
    return [r.output for r in reqs], steps


ENGINE_CASES = {  # arch, routing, n_slots, prompt lengths
    "stablelm": ("stablelm_1_6b", {}, 6, (23, 5, 3)),  # the reference's spreading test
    # capacity m / k: no expert can drop a token, so the two schedules
    # (another token order in the grid) give the same tokens
    "minimind_16e": ("minimind_moe_16e", {"strategy": "topk", "capacity_factor": 4.0}, 4, (19, 5, 3, 11)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_plans_and_streams_match_reference(case):
    """At every step the port's planner yields the reference's arrays
    (integers, bitwise), the streams are token for token the reference's,
    and the packed schedule takes fewer steps than the one-row-per-slot
    one (`_can_spread = False`) for the same tokens."""
    arch, routing, n_slots, lens = ENGINE_CASES[case]
    jm, jp, tm, tp = _built(arch, **routing)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (n,)).tolist() for n in lens]
    kw = dict(n_slots=n_slots, chunk_size=8, max_seq_len=64)
    je, te = JaxEngine(jm, jp, **kw), ContinuousBatchingEngine(tm, tp, **kw)
    assert te._can_spread and je._can_spread
    jplans, tplans = _record_plans(je), _record_plans(te)
    jout, jsteps = _run_stream(je, prompts)
    tout, tsteps = _run_stream(te, prompts)
    assert tout == jout and tsteps == jsteps
    assert [p is None for p in tplans] == [p is None for p in jplans]
    assert any(p is not None for p in tplans)
    for step, (got, want) in enumerate(zip(tplans, jplans)):
        for a, b in zip(got or (), want or ()):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
    legacy = ContinuousBatchingEngine(tm, tp, **kw)
    legacy._can_spread = False
    lout, lsteps = _run_stream(legacy, prompts)
    assert lout == tout and tsteps < lsteps


def _poison_padding(eng):
    """Overwrite every padded column's token (and, packed, position) with
    garbage right before each step program runs."""
    leg, pack = eng._serve_step, eng._serve_step_packed

    def poisoned_leg(tokens, lengths):
        pad = np.arange(tokens.shape[1])[None, :] >= lengths[:, None]
        return leg(np.where(pad, VOCAB - 1, tokens), lengths)

    def poisoned_pack(tokens, positions, segments, *rest):
        pad = segments < 0
        return pack(np.where(pad, VOCAB - 1, tokens), np.where(pad, 7, positions), segments, *rest)

    eng._serve_step, eng._serve_step_packed = poisoned_leg, poisoned_pack


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "minimind_moe_16e"])
def test_engine_masks_padded_columns(arch):
    """Garbage in padded columns reaches no sampled token and no attended
    K/V, over a schedule of partial chunks, packed segments and spread rows
    (the reference's test of the same name, on the port's engine)."""
    cfg = configs.reduced_for_smoke(arch, vocab_size=VOCAB)
    tm = Model(cfg, device="cpu")
    tp = tm.init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, (n,)).tolist() for n in (19, 5, 3, 11)]
    outs = []
    for poison in (False, True):
        eng = ContinuousBatchingEngine(tm, tp, n_slots=4, chunk_size=8, max_seq_len=64)
        plans = _record_plans(eng)
        if poison:
            _poison_padding(eng)
        outs.append(_run_stream(eng, prompts)[0])
        assert any(p is not None for p in plans)  # the packed program ran
    assert outs[0] == outs[1]
