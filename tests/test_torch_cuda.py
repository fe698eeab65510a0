"""The port on the GPU: the CUDA kernels against their plain versions, and
the serving engine launching them. Needs an NVIDIA GPU and nvcc; skips
elsewhere. Imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import moe_gemm  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(2, 5, 40, 24), (3, 37, 72, 200), (16, 160, 512, 1408)]  # (E, C, D, F)


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
