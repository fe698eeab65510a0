"""The seeded weights (inputs.make_params over a reference's leaf_specs): the
cells' weights are, bit for bit, those they had while bench/inputs.py still
laid out minimind's tree itself, and a fixed init overwrites its own slice of
the one draw and moves no other leaf."""
import hashlib

import pytest
import torch

from bench import harness, inputs
from bench.reference import minimind_moe
from bench.tests import _tiny


def _fingerprint(tree):
    """sha256 over each leaf's path and bytes, in the reference's leaf order,
    and the count of elements."""
    h, n = hashlib.sha256(), 0
    for path, t in minimind_moe.leaves(tree):
        h.update(path.encode())
        h.update(t.contiguous().numpy())
        n += t.numel()
    return h.hexdigest(), n


# recorded at seed 0 on the CPU with the layout in bench/inputs.py
@pytest.mark.parametrize("cell, digest, n", [
    (_tiny.cell, "e78ed9c89b2210dfaaefc16623ae6215b5650f853a3b8e24aa46fb45bb83b22b", 234_304),
    (lambda: harness.resolve("train-m16e-bip-s512"),
     "19a59304f705b93cde384938d025ec92362a7b116af651239d4d5ac853f29acf", 305_865_216),
], ids=["tiny", "minimind-moe-16e"])
def test_weights_are_the_cells_weights_bit_for_bit(cell, digest, n):
    assert _fingerprint(harness.weights(cell(), 0, "cpu")) == (digest, n)


def test_fixed_inits_overwrite_their_own_slice():
    specs = [
        (("a",), (3,), 0.5),
        (("b", "c"), (4,), torch.tensor([1.0, 2.0, 3.0, 4.0])),
        (("d", 0, "e"), (2, 2), 1.0),
        (("f",), (2,), torch.tensor(0.0)),
    ]
    tree = inputs.make_params(specs, 7, "cpu")
    draw = torch.randn(13, generator=torch.Generator().manual_seed(7))
    assert torch.equal(tree["a"], draw[:3] * 0.5)
    assert torch.equal(tree["b"]["c"], torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert torch.equal(tree["d"][0]["e"], draw[7:11].view(2, 2))
    assert torch.equal(tree["f"], torch.zeros(2))
