"""Port vs reference: the Mamba2 / SSD core (models/mamba2.py).

`ssd_chunked` against the reference's `ssd_chunked` and against the
step-by-step `ssd_reference` of both packages, with and without an initial
state, a sequence length that is not a multiple of the chunk, and one or
two B/C groups (two groups is where a tiled repeat instead of
repeat_interleave gives wrong numbers); then `mamba_chunk` against the
reference's on a cached state with per-row lengths of 0, fewer than
d_conv - 1, and the whole chunk, at C = 5, C = 1 (decode) and C = 32 (the
serving chunk: the reduced chunk_size, so min(chunk_size, C) = C). Inputs are drawn with
numpy; everything is fp32. Tolerance: 1e-5 (rtol and atol) throughout; the
port's softplus is jax's (logaddexp(x, 0)).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import mamba2 as jax_mamba  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(rng, groups, s=37, b=2, h=4, p=8, n=6):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32) * 0.5
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    bb = rng.standard_normal((b, s, groups, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, groups, n)).astype(np.float32)
    d_skip = rng.standard_normal(h).astype(np.float32)
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, a_log, bb, cc, d_skip, state


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(groups, with_state):
    args = _ssd_inputs(np.random.default_rng(groups + 2 * with_state), groups)
    *core, state = args
    init = state if with_state else None
    yj, sj = jax.jit(jax_mamba.ssd_chunked, static_argnames="chunk")(
        *map(jnp.asarray, core), chunk=16, init_state=None if init is None else jnp.asarray(init))
    yt, st = mamba2.ssd_chunked(*map(_t, core), chunk=16, init_state=None if init is None else _t(init))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    # both packages' sequential recurrence: the chunked form's oracle
    yr, sr = mamba2.ssd_reference(*map(_t, core), init_state=None if init is None else _t(init))
    yrj, srj = jax.jit(jax_mamba.ssd_reference)(*map(jnp.asarray, core),
                                                init_state=None if init is None else jnp.asarray(init))
    np.testing.assert_allclose(yr.numpy(), np.asarray(yrj), **TOL)
    np.testing.assert_allclose(sr.numpy(), np.asarray(srj), **TOL)
    np.testing.assert_allclose(yt.numpy(), yr.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), sr.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_groups_broadcast_as_repeat_interleave():
    """Group g serves heads g*rep .. g*rep + rep - 1: swapping the two
    groups' B and C swaps the two halves of the heads' outputs."""
    x, dt, a_log, bb, cc, d_skip, _ = _ssd_inputs(np.random.default_rng(7), 2)
    a_log[:] = a_log[0]  # heads alike but for their inputs
    d_skip[:] = 0.0
    x[:, :, 2:] = x[:, :, :2]
    dt[:, :, 2:] = dt[:, :, :2]
    y, _ = mamba2.ssd_chunked(*map(_t, (x, dt, a_log, bb, cc, d_skip)), chunk=16)
    ys, _ = mamba2.ssd_chunked(*map(_t, (x, dt, a_log, bb[:, :, ::-1], cc[:, :, ::-1], d_skip)), chunk=16)
    np.testing.assert_allclose(y[:, :, :2].numpy(), ys[:, :, 2:].numpy(), **TOL)
    assert not np.allclose(y[:, :, :2].numpy(), y[:, :, 2:].numpy(), atol=1e-3)


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_7b"])
@pytest.mark.parametrize("c, lengths", [(5, [5, 0, 2, 1]), (1, [1, 0, 1, 1]), (32, [32, 0, 2, 17])])
def test_mamba_chunk_matches_reference(arch, c, lengths):
    """A cached state advanced by a ragged chunk: valid outputs, the frozen
    SSM state of padded steps and the conv-cache gather of the last
    d_conv - 1 valid inputs (lengths 0 keeps the old cache)."""
    jcfg, tcfg = jax_configs.reduced_for_smoke(arch), configs.reduced_for_smoke(arch)
    assert jcfg.ssm.n_groups == (2 if arch == "zamba2_7b" else 1)
    pj = jax_mamba.init_mamba(jax.random.PRNGKey(3), jcfg)
    pj["dt_bias"] = jnp.linspace(-1.0, 1.0, pj["dt_bias"].shape[0])
    pt = {k: _t(v) for k, v in jax.device_get(pj).items()}
    rng = np.random.default_rng(11)
    b = len(lengths)
    xres = rng.standard_normal((b, c, jcfg.d_model)).astype(np.float32)
    cj = jax_mamba.init_mamba_cache(jcfg, b, jnp.float32)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in cj.items()}
    lens = np.asarray(lengths, np.int32)
    step = jax.jit(jax_mamba.mamba_chunk, static_argnums=3)
    oj, nj = step(pj, jnp.asarray(xres), {k: jnp.asarray(v) for k, v in cache.items()},
                  jcfg, lengths=jnp.asarray(lens))
    tcache = {k: _t(v) for k, v in cache.items()}
    ot, nt = mamba2.mamba_chunk(pt, _t(xres), tcache, tcfg, lengths=_t(lens).long())
    valid = np.arange(c)[None, :] < lens[:, None]
    np.testing.assert_allclose(ot.numpy()[valid], np.asarray(oj)[valid], **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(nt[k].numpy(), np.asarray(nj[k]), **TOL)
        assert nt[k] is tcache[k]  # written in place
    zero = lens == 0
    np.testing.assert_array_equal(nt["conv"].numpy()[zero], cache["conv"][zero])
    np.testing.assert_array_equal(nt["ssm"].numpy()[zero], cache["ssm"][zero])
