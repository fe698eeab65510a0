"""granite-4.0-h-small through the harness, added by files only: the cell's
configuration file holds the catalog's published numbers and maps onto the
port's registry config, and a tiny granite (bench/tests/_granite.py: the
whole period at width 64, 16 experts with 2 held) runs set-up, the checked
steps and the comparison with its plain reference on the CPU: correct in
fp32 and at the file's bf16, the fp8 control rejected."""
import collections
import copy
import json
import math
import time

import pytest

from bench import check, harness
from bench.metrics import step_mfu
from bench.reference import granite_moe_hybrid
from bench.tests import _granite

CELL = "train-granite-h-small-bip-s2048"
# the catalog's names for the port's fields, where a number of one is the other's
CATALOG = {"hidden_size": "d_model", "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
           "intermediate_size": "moe_d_ff", "shared_intermediate_size": "shared_d_ff",
           "num_hidden_layers": "n_layers", "num_local_experts": "experts_held", "vocab_size": "vocab_size",
           "rms_norm_eps": "rms_norm_eps", "attention_multiplier": "attn_scale",
           "embedding_multiplier": "embedding_multiplier", "residual_multiplier": "residual_multiplier",
           "logits_scaling": "logits_scaling", "max_position_embeddings": "max_seq_len",
           "tie_word_embeddings": "tie_embeddings"}
MAMBA = {"mamba_d_state": "d_state", "mamba_d_conv": "d_conv", "mamba_expand": "expand",
         "mamba_d_head": "head_dim", "mamba_n_groups": "n_groups", "mamba_chunk_size": "chunk_size"}


def _numbers(cell, seed, precision="fp32"):
    prog = harness.build_program(cell, seed, "cpu")
    got = harness.checked_steps(prog, cell, seed, "cpu")
    want = harness.reference_records(cell, seed, prog.pool, "cpu")
    assert len(got["q"][0]) == len(want["q"][0]) == 10  # every layer has a router
    if precision != "fp32":  # the control: the reference in the program's place
        got = harness.reference_records(cell, seed, prog.pool, "cpu", precision)
    return check.numbers(got, want)


def test_cells_file_holds_the_published_numbers_and_the_ports():
    cell = harness.resolve(CELL)
    doc, cfg = cell.config, harness.port_config(cell.config, cell.mix)
    for key, field in CATALOG.items():
        assert doc[key] == getattr(cfg, field), key
    for key, field in MAMBA.items():
        assert doc[key] == getattr(cfg.ssm, field), key
    assert cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim == doc["mamba_n_heads"]
    assert (doc["num_experts_per_tok"], doc["num_local_experts"]) == (cfg.routing.top_k, cfg.experts_held)
    assert doc["published"]["num_local_experts"] == cfg.routing.n_experts == 72
    assert doc["position_embedding_type"] == "nope" and cfg.nope
    assert [t == "attention" for t in doc["layer_types"]] == [k == "global" for k, _ in cfg.layer_kinds()]
    assert doc["published"]["layer_types"][:10] == doc["layer_types"]
    assert (cfg.n_layers, cfg.vocab_size, cfg.experts_held) == (10, 12544, 9)


def test_cell_resolves_from_its_files_with_its_own_metrics():
    """The cell runs BIP on K3 in bf16 over one row of 2,048 tokens, reports
    the per-layer metrics whose `workloads` name it (all that list none), and
    BENCHMARK.json's `reduced` names exactly the catalog keys the file changed."""
    cell = harness.resolve(CELL)
    cfg = harness.port_config(cell.config, cell.mix)
    assert cfg.routing.strategy == "bip" and cfg.routing.use_kernel
    assert cfg.compute_dtype == harness.torch.bfloat16
    assert cell.tokens_per_step == 2048
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "train_tokens_per_s"}
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    mine = {m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert {m["name"] for m in cell.per_layer} == mine >= {"mamba_ms_per_step", "ssd_ms_per_step"}
    assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap", "q1_gap", "load1_gap"}
    for lim in cell.limits.values():
        assert lim["lower"] < lim["limit"] < lim["upper"]
    entry = next(c for c in spec["configs"] if c["name"] == cell.config["name"])
    assert set(entry["reduced"]) == set(cell.config["published"])
    assert all(cell.config[k] != v for k, v in cell.config["published"].items())


@pytest.mark.parametrize("group, key, value, named", [
    (None, "residual_multiplier", 0.25, "residual_multiplier"),
    (None, "nope", False, "nope"),
    ("ssm", "d_state", 64, "ssm.d_state"),
    ("routing", "norm_topk_prob", False, "routing.norm_topk_prob"),
])
def test_config_guard_names_the_granite_key(group, key, value, named):
    cell = harness.resolve(CELL)
    doc = copy.deepcopy(cell.config)
    (doc["config"][group] if group else doc["config"])[key] = value
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        harness.port_config(doc, cell.mix)


def test_tiny_port_config_takes_the_reduced_keys():
    cfg = harness.port_config(_granite.cell().config, _granite.cell().mix)
    assert (cfg.n_layers, cfg.d_model, cfg.routing.n_experts, cfg.experts_held, cfg.ssm.d_state) == (10, 64, 16, 2, 16)
    assert (cfg.ssm.d_conv, cfg.ssm.n_groups, cfg.residual_multiplier, cfg.routing.bip_iters) == (4, 1, 0.22, 4)


def test_the_port_agrees_with_the_reference_in_fp32():
    """fp32 on both sides (CPU): loss 8.6e-8, gradient 4.6e-7, update 2.7e-6
    at seed 100; the routing is the same."""
    nums = _numbers(_granite.cell(compute_dtype="float32"), 100)
    assert nums["loss_gap"] < 1e-6 and nums["grad_gap"] < 1e-5 and nums["update_gap"] < 1e-4
    assert nums["q1_gap"] == 0 and nums["load1_gap"] == 0
    assert check.verdict(nums, _granite.cell().limits)


@pytest.mark.parametrize("seed", [100, 101])
def test_sound_run_is_correct_and_the_fp8_control_is_not(seed):
    cell = _granite.cell()
    assert check.verdict(_numbers(cell, seed), cell.limits)
    assert not check.verdict(_numbers(cell, seed, "fp8"), cell.limits)


@pytest.mark.parametrize("trace", [False, True])
def test_whole_run(trace):
    out = harness.run_cell(_granite.cell(), 102, 0.2, trace, "cpu", time.monotonic())
    assert out["correct"], out["checks"]
    # on the CPU no reader has a device trace; MaxVio is the program's counter
    want = {"avg_maxvio"} if trace else {"train_tokens_per_s", "step_ms_p90", "peak_mem_gib", "setup_s"}
    assert set(out["metrics"]) == want


def test_step_mfu_reads_granites_count():
    """The cell's FLOPs per token at 2,048 tokens, term by term (each 6 per
    matmul parameter, 3 times the forward's activation products)."""
    cfg = harness.resolve(CELL).config["config"]
    mamba_proj = 6.0 * 9 * (4096 * 16768 + 8192 * 4096)
    ssd = 3.0 * 9 * 2 * (1 * 128 * 128 + 128 * (128 * 64 + 2 * 128 * 64))
    attention = 6.0 * (4096 * 48 * 128 + 32 * 128 * 4096) + 6.0 * 2048 * 32 * 128
    shared = 6.0 * 10 * (3 * 4096 * 1536 + 4096 * 72)
    routed = 6.0 * 10 * 10 * 9 / 72 * 3 * 4096 * 768
    head = 6.0 * 4096 * 12544
    flops = mamba_proj + ssd + attention + shared + routed + head
    assert granite_moe_hybrid.model_flops_per_token(cfg, 2048) == pytest.approx(flops, rel=1e-12)
    rec = {"busy_s": 0.5, "window_s": 1.0, "steps": 2, "tokens_per_step": 2048, "config": cfg,
           "reference": "bench.reference.granite_moe_hybrid", "mix": {"seq_len": 2048}}
    assert step_mfu.read(rec) == pytest.approx(100 * flops * 2048 * 2 / 989e12, rel=1e-12)


def test_specs_lay_out_the_cells_parameters():
    """2.055 B parameters on the device: 9 Mamba layers of 102.3 M, one
    attention layer of 41.9 M, 10 MoE FFNs of 104.1 M (84.9 M in the 9
    experts held), the embedding's 51.4 M and the final norm."""
    cfg = harness.resolve(CELL).config["config"]
    sizes = collections.Counter()
    for keys, shape, _ in granite_moe_hybrid.leaf_specs(cfg):
        sizes[keys[3] if keys[0] == "stack" else keys[0]] += math.prod(shape)
    assert sizes["mamba"] == 9 * (4096 * 16768 + 4 * 8448 + 8448 + 3 * 128 + 8192 + 8192 * 4096)
    assert sizes["attn"] == 4096 * 48 * 128 + 32 * 128 * 4096
    assert sizes["moe"] == 10 * (4096 * 72 + 3 * 9 * 4096 * 768)
    assert sizes["shared_mlp"] == 10 * 3 * 4096 * 1536 and sizes["embed"] == 12544 * 4096
    assert sizes["pre_norm"] == sizes["ffn_norm"] == 10 * 4096 and sizes["final_norm"] == 4096
    assert sum(sizes.values()) == 2_055_031_424
