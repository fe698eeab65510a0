"""Port vs reference: the grouped expert-FFN kernels (K1/K2).

The same numpy inputs go through the reference's Pallas path (interpret mode
on the CPU, as its own tests run it), its jnp oracles, and the port's
wrappers, which on CPU tensors run their plain versions. fp32 throughout;
C in {5, 37} and F not a multiple of 128. Tolerance: rtol 1e-5 (plus an
atol of 1e-6 for entries near zero) — both sides sum the same fp32 products
in different orders. The CUDA dispatch itself is checked on a GPU, by
tests/test_torch_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import moe_gemm, ops, ref  # noqa: E402

SHAPES = [(2, 5, 40, 24), (3, 37, 72, 200)]  # (E, C, D, F)
RTOL, ATOL = 1e-5, 1e-6


def _inputs(shape, seed=0):
    e, c, d, f = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wg = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, wg, wu, wd


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_gated_ffn_in_matches_reference(shape):
    x, wg, wu, _ = _inputs(shape)
    h = moe_gemm.grouped_gated_ffn_in(*_t(x, wg, wu)).numpy()
    want_ref = np.asarray(jax_ref.gated_ffn_in_ref(x, wg, wu))
    want_pallas = np.asarray(jax_ops.grouped_gated_ffn_in(x, wg, wu))
    np.testing.assert_allclose(h, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h, want_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_matmul_matches_reference(shape):
    x, wg, wu, wd = _inputs(shape, seed=1)
    h = np.asarray(jax_ref.gated_ffn_in_ref(x, wg, wu))
    y = moe_gemm.grouped_matmul(*_t(h, wd)).numpy()
    np.testing.assert_allclose(y, np.asarray(jax_ref.grouped_matmul_ref(h, wd)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, np.asarray(jax_ops.grouped_matmul(h, wd)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_expert_ffn_matches_reference(shape):
    x, wg, wu, wd = _inputs(shape, seed=2)
    y = ops.expert_ffn(*_t(x, wg, wu, wd)).numpy()
    want = np.asarray(jax_ops.expert_ffn(x, wg, wu, wd))  # auto-padded Pallas pair
    np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ref.expert_ffn_ref(*_t(x, wg, wu, wd)).numpy(),
        np.asarray(jax_ref.expert_ffn_ref(x, wg, wu, wd)), rtol=RTOL, atol=ATOL,
    )


def test_cpu_path_keeps_dtype_and_counts_no_launch(monkeypatch):
    """CPU tensors take the plain version only: nothing is built or launched."""

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(moe_gemm, "build", no_build)
    x, wg, wu, wd = _t(*_inputs(SHAPES[0]))
    moe_gemm.reset_launch_counts()
    xb, wgb, wub, wdb = (a.to(torch.bfloat16) for a in (x, wg, wu, wd))
    h = moe_gemm.grouped_gated_ffn_in(xb, wgb, wub)
    y = moe_gemm.grouped_matmul(h, wdb)
    assert h.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    assert moe_gemm.grouped_gated_ffn_in.launches == 0
    assert moe_gemm.grouped_matmul.launches == 0


@pytest.mark.parametrize(
    "bad, err",
    [
        ("float16", TypeError),
        ("mixed_dtype", TypeError),
        ("rank", ValueError),
        ("shape", ValueError),
        ("noncontiguous", ValueError),
    ],
)
def test_wrappers_reject_bad_input(bad, err):
    x, wg, wu, wd = _t(*_inputs(SHAPES[1]))
    if bad == "float16":
        x, wg, wu = x.half(), wg.half(), wu.half()
    elif bad == "mixed_dtype":
        wg = wg.double()
    elif bad == "rank":
        x = x[0]
    elif bad == "shape":
        wu = wu[:, :-1]
    elif bad == "noncontiguous":
        wg = wg.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err):
        moe_gemm.grouped_gated_ffn_in(x, wg, wu)
    h = moe_gemm.grouped_gated_ffn_in_plain(*_t(*_inputs(SHAPES[1])[:3]))
    if bad in ("float16", "mixed_dtype"):
        h, wd = (h.half(), wd.half()) if bad == "float16" else (h, wd.double())
    elif bad == "rank":
        h = h[0]
    elif bad == "shape":
        wd = wd[:, :-1]
    elif bad == "noncontiguous":
        wd = wd.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err):
        moe_gemm.grouped_matmul(h, wd)
