"""The plain reference against the port's CPU path at a tiny size."""
import pytest
import torch

from bench import check, harness
from bench.reference import minimind_moe
from bench.tests import _tiny


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_agrees_with_the_port_in_fp32(seed):
    cell = _tiny.cell(compute_dtype="float32")
    prog = harness.build_program(cell, seed, "cpu")
    got = harness.checked_steps(prog, cell, seed, "cpu")
    want = harness.reference_records(cell, seed, prog.pool, "cpu")
    nums = check.numbers(got, want)
    # fp32 on both sides: the first step agrees to rounding; later steps
    # may part by a capacity tie (the BIP boundary is degenerate)
    assert nums["loss1_gap"] < 1e-6
    assert nums["grad_gap"] < 1e-5
    assert nums["q1_gap"] < 1e-5
    assert nums["load1_gap"] == 0
    assert got["loss"][0] == pytest.approx(want["loss"][0], rel=1e-6)


@pytest.mark.parametrize("n, m, k, iters", [(1000, 16, 4, 4), (777, 64, 8, 14), (300, 4, 4, 2)])
def test_dual_matches_the_ports_plain_dual(n, m, k, iters):
    from repro_torch.kernels.bip_admm import bip_dual_update_plain

    gen = torch.Generator().manual_seed(n + m)
    s = torch.softmax(torch.randn(n, m, generator=gen) + torch.linspace(2, -2, m), dim=-1)
    q0 = torch.rand(m, generator=gen) * 0.05
    want = bip_dual_update_plain(s, q0, top_k=k, n_iters=iters)
    torch.testing.assert_close(minimind_moe.dual_update(s, q0, k, iters), want, rtol=0, atol=1e-6)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    err = {p: float((minimind_moe._round(x, p) - x).abs().max()) for p in ("fp32", "bf16", "fp8")}
    assert err["fp32"] == 0 < err["bf16"] < err["fp8"]
