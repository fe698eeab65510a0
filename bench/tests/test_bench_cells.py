"""Every cell of BENCHMARK.json resolves by name from its files, and the
configuration guard holds the port's config to the benchmark's file."""
import copy
import importlib
import json

import pytest

from bench import harness
from bench.tests import _tiny

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = harness.resolve(name)
    cfg = harness.port_config(cell.config, cell.mix)
    assert cfg.routing.strategy == "bip" and cfg.routing.use_kernel
    assert cfg.compute_dtype == harness.torch.bfloat16
    assert cell.tokens_per_step == 16384
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "train_tokens_per_s"}
    assert {m["name"] for m in cell.per_layer} == {m["name"] for m in SPEC["per_layer"]}
    assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap", "q1_gap", "load1_gap"}
    for lim in cell.limits.values():
        assert lim["lower"] < lim["limit"] < lim["upper"]


def test_every_per_layer_metric_has_a_reader():
    layers = {}
    for m in SPEC["per_layer"]:
        assert callable(importlib.import_module(f"bench.metrics.{m['name']}").read)
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_config_files_lie_under_the_paths():
    for c in SPEC["configs"]:
        assert c["file"].split("/")[0] in SPEC["paths"]
        doc = json.loads((harness.ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("key, value, named", [
    ("d_model", 1024, "d_model"),
    ("vocab_size", 6401, "vocab_size"),
    ("routing", {"top_k": 2}, "routing.top_k"),
])
def test_config_guard_names_the_key(key, value, named):
    cell = harness.resolve(CELLS[0])
    doc = copy.deepcopy(cell.config)
    if key == "routing":
        doc["config"]["routing"].update(value)
    else:
        doc["config"][key] = value
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        harness.port_config(doc, cell.mix)


def test_reduced_keys_take_the_files_values():
    cfg = harness.port_config(_tiny.cell().config, _tiny.cell().mix)
    assert (cfg.n_layers, cfg.d_model, cfg.routing.n_experts, cfg.routing.top_k) == (2, 64, 4, 2)
    assert cfg.routing.bip_iters == 4 and cfg.routing.use_kernel


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.resolve("no-such-cell")


# a configuration file with a nested spec (`ssm`) and a tuple field
# (`attn_pattern`), as JSON writes them, for the port's mamba2-130m
MAMBA2 = """{"name": "mamba2-130m", "registry": "mamba2_130m", "reference": "none", "reduced": [],
 "config": {"n_layers": 24, "d_model": 768, "vocab_size": 50280, "family": "ssm",
            "attn_pattern": ["global"], "compute_dtype": "bfloat16",
            "ssm": {"d_state": 128, "d_conv": 4, "expand": 2, "head_dim": 64, "n_groups": 1,
                    "chunk_size": 128}}}"""


def test_config_guard_takes_nested_specs_and_lists():
    from repro_torch import configs

    assert harness.port_config(json.loads(MAMBA2), {}) == configs.get("mamba2_130m")


@pytest.mark.parametrize("group, key, value, named", [
    ("ssm", "d_state", 64, "ssm.d_state"),
    ("ssm", "chunk_size", 256, "ssm.chunk_size"),
    (None, "attn_pattern", ["local"], "attn_pattern"),
])
def test_config_guard_names_the_nested_key(group, key, value, named):
    doc = json.loads(MAMBA2)
    (doc["config"][group] if group else doc["config"])[key] = value
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        harness.port_config(doc, {})


def test_dotted_reduced_keys_take_the_files_values():
    doc = json.loads(MAMBA2)
    doc["config"]["n_layers"], doc["config"]["ssm"]["d_state"] = 2, 16
    doc["reduced"] = ["n_layers", "ssm.d_state"]
    cfg = harness.port_config(doc, {})
    assert (cfg.n_layers, cfg.ssm.d_state, cfg.ssm.chunk_size, cfg.attn_pattern) == (2, 16, 128, ("global",))
    cell = harness.resolve(CELLS[0])
    doc = copy.deepcopy(cell.config)
    doc["config"]["routing"]["n_experts"] = 8
    doc["reduced"] = ["routing.n_experts"]
    cfg = harness.port_config(doc, cell.mix)
    assert (cfg.routing.n_experts, cfg.routing.top_k, cfg.routing.strategy) == (8, 4, "bip")
