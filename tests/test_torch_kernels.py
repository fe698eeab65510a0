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
        ("unequal_strides", ValueError),
        ("zero_stride", ValueError),
    ],
)
def test_wrappers_reject_bad_input(bad, err):
    """Malformed operands raise. Strided views are taken (see the next
    test), except an expanded one (a zero stride) and, for K1, gate and up
    weights of unequal strides (the kernel takes one stride triple for
    both); 'unequal_strides' has no K2 counterpart."""
    x, wg, wu, wd = _t(*_inputs(SHAPES[1]))
    if bad == "float16":
        x, wg, wu = x.half(), wg.half(), wu.half()
    elif bad == "mixed_dtype":
        wg = wg.double()
    elif bad == "rank":
        x = x[0]
    elif bad == "shape":
        wu = wu[:, :-1]
    elif bad == "unequal_strides":
        wg = wg.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "zero_stride":
        x = x[:, :1].expand(-1, x.shape[1], -1)
    with pytest.raises(err):
        moe_gemm.grouped_gated_ffn_in(x, wg, wu)
    h = moe_gemm.grouped_gated_ffn_in_plain(*_t(*_inputs(SHAPES[1])[:3]))
    if bad in ("float16", "mixed_dtype"):
        h, wd = (h.half(), wd.half()) if bad == "float16" else (h, wd.double())
    elif bad == "rank":
        h = h[0]
    elif bad == "shape":
        wd = wd[:, :-1]
    elif bad == "zero_stride":
        wd = wd[:, :, :1].expand(-1, -1, wd.shape[2])
    if bad == "unequal_strides":
        return
    with pytest.raises(err):
        moe_gemm.grouped_matmul(h, wd)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrappers_take_transposed_views(shape):
    """Transposed views, as the expert-FFN backward passes them, give what
    .contiguous() copies of them give."""
    x, wg, wu, wd = _t(*_inputs(shape, seed=3))
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    wg_v, wu_v = t(t(wg).contiguous()), t(t(wu).contiguous())  # same values, strided
    assert not wg_v.is_contiguous()
    torch.testing.assert_close(
        moe_gemm.grouped_gated_ffn_in(x, wg_v, wu_v), moe_gemm.grouped_gated_ffn_in(x, wg, wu),
        rtol=RTOL, atol=ATOL,
    )
    h = moe_gemm.grouped_gated_ffn_in(x, wg, wu)
    for a, b in ((h, t(t(wd).contiguous())), (t(x), x), (t(h), t(t(h).contiguous()))):
        torch.testing.assert_close(
            moe_gemm.grouped_matmul(a, b),
            moe_gemm.grouped_matmul(a.contiguous(), b.contiguous()), rtol=RTOL, atol=ATOL,
        )


# The nine K2 products of ops._ExpertFFN (forward, then the eight backward
# uses in their order) and the (A, B) layout pair the bf16 kernel reads
# each in: 'K' when the operand's reduction axis has unit stride, 'MN' when
# its M or N axis has.
EXPERT_FFN_PRODUCTS = [
    ("y = h wd", ("K", "MN")),
    ("g = x wg", ("K", "MN")),
    ("u = x wu", ("K", "MN")),
    ("dh = dy wd^T", ("K", "K")),
    ("dwd = h^T dy", ("MN", "MN")),
    ("dx_g = dg wg^T", ("K", "K")),
    ("dx_u = du wu^T", ("K", "K")),
    ("dwg = x^T dg", ("MN", "MN")),
    ("dwu = x^T du", ("MN", "MN")),
]


def _expert_ffn_operands(monkeypatch, shape=(2, 24, 16, 40)):
    """The (A, B) operands of every K2 call of one bf16 forward and backward
    of ops.expert_ffn on CPU tensors, as the autograd Function builds them."""
    x, wg, wu, wd = (a.to(torch.bfloat16).requires_grad_(True)
                     for a in _t(*_inputs(shape, seed=4)))
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(x.shape).astype(np.float32))
    calls = []

    def recording(a, b):
        calls.append((a, b))
        return moe_gemm.grouped_matmul_plain(a, b)

    monkeypatch.setattr(moe_gemm, "grouped_matmul", recording)
    ops.expert_ffn(x, wg, wu, wd).backward(dy.to(torch.bfloat16))
    return calls


@pytest.mark.parametrize("i", range(len(EXPERT_FFN_PRODUCTS)),
                         ids=[name for name, _ in EXPERT_FFN_PRODUCTS])
def test_tma_layout_of_expert_ffn_products(monkeypatch, i):
    """Every operand the expert FFN hands to K2 is taken by the bf16
    kernel's TMA check as it lies (no copy), in the layout pair the kernel
    is instantiated for: K-major x/h/dy/dg/du and MN-major weights in the
    forward, K-major transposed weights in dh and dx, MN-major transposed
    activations in the weight gradients. Widths are multiples of 8."""
    calls = _expert_ffn_operands(monkeypatch)
    assert len(calls) == len(EXPERT_FFN_PRODUCTS)
    a, b = calls[i]
    pair, sa, sb = moe_gemm.tma_layout(a, b)
    assert pair == EXPERT_FFN_PRODUCTS[i][1]
    assert sa == a.stride() and sb == b.stride()  # no size-1 axis: strides pass as they are


@pytest.mark.parametrize(
    "case", ["row_stride_24_bytes", "no_unit_stride", "misaligned_base", "expert_stride"]
)
def test_tma_layout_refuses(case):
    """What TMA cannot describe raises ValueError naming the constraint: a
    non-unit stride that is not a multiple of 16 bytes (12 bf16 values =
    24 bytes), no unit stride among the last two axes, a base address off
    the 16-byte grain, and an expert stride off it."""
    bf = torch.bfloat16
    a, b = torch.zeros(2, 8, 16, dtype=bf), torch.zeros(2, 16, 8, dtype=bf)
    if case == "row_stride_24_bytes":
        a = torch.zeros(2, 8, 12, dtype=bf)[:, :, :10]
        b = torch.zeros(2, 10, 8, dtype=bf)
    elif case == "no_unit_stride":
        a = torch.zeros(2, 8, 32, dtype=bf)[:, :, ::2]
    elif case == "misaligned_base":
        a = torch.zeros(2 * 8 * 16 + 1, dtype=bf)[1:].view(2, 8, 16)
    else:
        a = torch.zeros(2, 8 * 16 + 4, dtype=bf)[:, :128].view(2, 8, 16)
    with pytest.raises(ValueError, match="TMA|16-byte"):
        moe_gemm.tma_layout(a, b)


@pytest.mark.parametrize("c", [1, 2])
def test_tma_layout_takes_size_one_axes(c):
    """A decode step's C=1 (and one expert) leaves axes of size 1, whose
    strides address nothing: they are accepted in either view, and given
    strides that TMA takes."""
    bf = torch.bfloat16
    x, w, dy = torch.zeros(1, c, 16, dtype=bf), torch.zeros(1, 16, 24, dtype=bf), torch.zeros(1, c, 24, dtype=bf)
    for a, b in ((x, w), (x.transpose(1, 2), dy), (dy, w.transpose(1, 2))):
        pair, sa, sb = moe_gemm.tma_layout(a, b)
        assert all(s % 8 == 0 for s in sa if s != 1) and all(s % 8 == 0 for s in sb if s != 1)
        assert 1 in sa and 1 in sb

