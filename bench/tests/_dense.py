"""A configuration the benchmark's own files do not have, added through files
only: phi4-mini-3.8b cut to 2 layers of width 64 (data/tiny-dense.json), a
dense GQA model with no router layer, under a mix with no routing path
(data/traffic/tiny-dense.json) and limits of its own
(data/limits/tiny-dense.json). Its plain reference is this module:
`leaf_specs`, `model_flops_per_token` and `train_steps`, as
bench/reference/<reference>.py gives them for a cell of BENCHMARK.json."""
import dataclasses
import math
from pathlib import Path
from typing import Dict

import torch.nn.functional as F

from bench import harness
from bench.reference.minimind_moe import ONE, _mm, adamw_steps, attention, rmsnorm, swiglu

DATA = Path(__file__).resolve().parent / "data"
SPEC = {
    "configs": [{"name": "tiny-dense", "file": "bench/tests/data/tiny-dense.json"}],
    "workloads": [{"name": "tiny-dense", "config": "tiny-dense", "traffic": "tiny-dense", "chips": 1}],
    "end_to_end": [{"name": n, "unit": u} for n, u in (
        ("train_tokens_per_s", "tokens/s"), ("step_ms_p90", "ms"), ("peak_mem_gib", "GiB"), ("setup_s", "s"))],
    "per_layer": [{"name": n, "unit": u, "moves": "train_tokens_per_s"}
                  for n, u in (("step_mfu", "%"), ("avg_maxvio", "ratio"))],
}


def cell(**config_changes) -> harness.Cell:
    c = harness.resolve("tiny-dense", SPEC, base=DATA)
    c = dataclasses.replace(c, reference=__name__, config=dict(c.config, config=dict(c.config["config"])))
    c.config["config"].update(config_changes)
    c.config["reduced"] = c.config["reduced"] + list(config_changes)
    return c


def leaf_specs(cfg: dict):
    """The dense tree: per layer pre-norm, attention, ffn norm and a SwiGLU
    MLP; the tied embedding; the final norm (inits as minimind's)."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    f, n_layers, v = cfg["d_ff"], cfg["n_layers"], cfg["vocab_size"]
    s_in, deep = 1.0 / math.sqrt(d), 1.0 / math.sqrt(2 * n_layers)
    layer = [
        (("pre_norm", "scale"), (d,), ONE),
        (("attn", "wq"), (d, h, hd), s_in),
        (("attn", "wk"), (d, kv, hd), s_in),
        (("attn", "wv"), (d, kv, hd), s_in),
        (("attn", "wo"), (h, hd, d), s_in * deep),
        (("ffn_norm", "scale"), (d,), ONE),
        (("mlp", "w_gate"), (d, f), s_in),
        (("mlp", "w_up"), (d, f), s_in),
        (("mlp", "w_down"), (f, d), deep / math.sqrt(f)),
    ]
    out = [(("embed", "tok"), (v, d), s_in)]
    out += [(("stack", "layers", i) + keys, shape, init)
            for i in range(n_layers) for keys, shape, init in layer]
    out.append((("final_norm", "scale"), (d,), ONE))
    return out


def model_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 per matmul parameter (attention, the MLP, the tied head) plus causal
    attention's 6 L S d."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    per_layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * cfg["d_ff"]
    params = cfg["n_layers"] * per_layer + d * cfg["vocab_size"]
    return 6.0 * params + 6.0 * cfg["n_layers"] * seq_len * d


def loss_fn(params, tokens, labels, cfg: dict, prec: str):
    eps = cfg["rms_norm_eps"]
    x = params["embed"]["tok"][tokens]
    for lp in params["stack"]["layers"]:
        x = x + attention(lp["attn"], rmsnorm(x, lp["pre_norm"]["scale"], eps), cfg, prec)
        mlp = lp["mlp"]
        xn = rmsnorm(x, lp["ffn_norm"]["scale"], eps)
        x = x + swiglu(xn, mlp["w_gate"], mlp["w_up"], mlp["w_down"], prec)
    x = rmsnorm(x, params["final_norm"]["scale"], eps)
    logits = _mm("bsd,vd->bsv", x, params["embed"]["tok"], prec)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def train_steps(params, batches, cfg: dict, mix: dict, precision: str = "fp32") -> Dict[str, list]:
    """AdamW steps; no layer has a router, so nothing is recorded beside the loss."""
    return adamw_steps(params, batches, mix,
                       lambda b: (loss_fn(params, b["tokens"], b["labels"], cfg, precision), {}))

