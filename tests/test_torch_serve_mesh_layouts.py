"""The port's engine on a 2x4 mesh for every layout the reference's
`cache_specs` gives the slot cache (tests/_torch_mesh_ranks.LAYOUT_CASES):
SSM heads and state N over 'model' (mamba2, zamba2 with its shared
attention block), the cache length over 'data' (one long request; gemma2's
sliding-window ring wrapping), head_dim over 'model', a cache replicated
over 'model', and one minimind-16e request through the expert-parallel MoE
layers under topk and bip. Eight gloo ranks, and the reference's mesh
engine on its forced 8-device mesh in one subprocess beside them, serve
three seeded prompts, 5 greedy tokens each, chunk 8, max_seq_len 64, from
the reference's params (converted); the port's one-device engine serves
them too.

Contract: each case takes the layout it names (the reference's own spec);
the dense families and topk are bit-equal in tokens and per-expert loads
to the reference's mesh and the port's one device, and their fp32 logits
within LOGITS_RTOL of one device's (the length-split softmax and the
head_dim-split scores are reassociated: measured up to ~1.2e-6); bip
holds the reference's degeneracy contract (tokens equal, load totals
equal, L1 <= 8) against the reference's mesh and the port's one device,
while the reference's own mesh parts from its one device here (ROADMAP,
Reference caveats).
"""
from __future__ import annotations

import os
import pickle
import threading
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _forced_devices import PRELUDE  # noqa: E402
from _torch_mesh_ranks import LAYOUT_CASES, layout_cfg, layout_checks, layout_params, layout_stream  # noqa: E402
from _torch_mesh_util import alongside, run_ranks  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402

LOGITS_RTOL = 1e-5
BIP_L1 = 8  # tests/test_serving_mesh.py:66
NAMES = [case[0] for case in LAYOUT_CASES]
CASES = dict((case[0], case) for case in LAYOUT_CASES)

REF = r"""
import pickle
sys.path.insert(0, "tests")
from repro import configs
from repro.distributed.sharding import cache_specs
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.serving import ContinuousBatchingEngine
from _torch_mesh_ranks import LAYOUT_CASES, LAYOUT_MESH, layout_cfg, layout_params, layout_stream

out = {}
for case in LAYOUT_CASES:
    cfg = layout_cfg(configs, case)
    model, params = build_model(cfg), jax.tree.map(jnp.asarray, layout_params(WD, case[0]))
    mesh = make_host_mesh(*LAYOUT_MESH)
    tokens, load, _, eng = layout_stream(ContinuousBatchingEngine, model, params, case[3], mesh)
    specs = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(cache_specs(eng.cache, cfg, mesh, case[3]))[0]:
        specs.setdefault(path[-1].key, tuple(spec)[1:])  # without the group stack's axis
    out[case[0]] = {"tokens": tokens, "load": load, "specs": specs}
    if case[4] == "bip":  # the reference's own one device, which its mesh parts from here
        out[case[0]]["one_device"] = layout_stream(ContinuousBatchingEngine, model, params, case[3])[:2]
with open(WD + "/layout_ref.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _write_params(wd):
    """The reference's PRNGKey(0) init of each case, written case by case
    (`layout_params` reads them) while the earlier cases are served."""
    for case in LAYOUT_CASES:
        path = wd / f"layout_params_{case[0]}.pkl"
        try:
            tree = jax.device_get(jax_build_model(layout_cfg(jax_configs, case)).init(jax.random.PRNGKey(0)))
        except BaseException:
            path.with_suffix(".error").write_text(traceback.format_exc())
            raise
        with open(path.with_suffix(".tmp"), "wb") as f:
            pickle.dump(tree, f)
        os.replace(path.with_suffix(".tmp"), path)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    wd = tmp_path_factory.mktemp("serve_mesh_layouts")
    writer = threading.Thread(target=_write_params, args=(wd,))
    writer.start()
    try:
        ranks = alongside(PRELUDE + f"WD = {str(wd)!r}\n" + REF, lambda: run_ranks(layout_checks, 8, wd))
    finally:
        writer.join()
    with open(wd / "layout_ref.pkl", "rb") as f:
        ref = pickle.load(f)
    single = {}
    for case in LAYOUT_CASES:
        cfg = layout_cfg(configs, case)
        single[case[0]] = layout_stream(ContinuousBatchingEngine, Model(cfg, device="cpu"),
                                        params_from_numpy(layout_params(wd, case[0]), cfg, "cpu"), case[3],
                                        logits=True)[:3]
    return ranks, ref, single


@pytest.mark.parametrize("name", NAMES)
def test_cache_layout(layouts, name):
    """The slot cache takes the layout the case names on every rank, and
    it is the reference's own (cache_specs on its engine's cache)."""
    ranks, ref, _ = layouts
    want = CASES[name][5]
    for r in ranks:
        assert r[name]["specs"] == want
    assert ref[name]["specs"] == want


@pytest.mark.parametrize("name", NAMES)
def test_mesh_serves_like_one_device(layouts, name):
    """Every rank samples the same tokens. Dense and topk: tokens and
    per-expert loads bit-equal to the reference's mesh engine and the
    port's one-device engine (the replicated case would double its output
    if a psum ran over the axis it is replicated over). bip: the
    reference's degeneracy contract against both, and the reference's own
    mesh parts from its one device (the caveat this records)."""
    ranks, ref, single = layouts
    got = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["tokens"] == got["tokens"]
        np.testing.assert_array_equal(r[name]["load"], got["load"])
    others = ((ref[name]["tokens"], np.asarray(ref[name]["load"])), single[name][:2])
    if CASES[name][4] != "bip":
        for tokens, load in others:
            assert got["tokens"] == tokens
            np.testing.assert_array_equal(got["load"], load)
        return
    for tokens, load in others:
        assert got["tokens"] == tokens
        assert got["load"].sum() == load.sum()
        assert float(np.abs(got["load"] - load).sum()) <= BIP_L1, (got["load"], load)
    assert ref[name]["one_device"][0] != ref[name]["tokens"], "the reference's mesh no longer parts from one device"


@pytest.mark.parametrize("name", [n for n in NAMES if CASES[n][4] != "bip"])
def test_fp32_logits_within_tolerance(layouts, name):
    """The logits every step sampled from, per active slot, on the mesh
    against one device: relative L2 <= LOGITS_RTOL (fp32)."""
    ranks, _, single = layouts
    mesh_rows, one_rows = ranks[0][name]["logits"], single[name][2]
    assert len(mesh_rows) == len(one_rows)
    gap = max(float(np.linalg.norm(a - b, axis=-1).max() / np.linalg.norm(b, axis=-1).min())
              for a, b in zip(mesh_rows, one_rows))
    assert gap <= LOGITS_RTOL, gap
