"""Plain PyTorch reference of BIP-balanced pre-training of granite-4.0-h-small
(IBM Granite 4.0-H Small, https://huggingface.co/ibm-granite/granite-4.0-h-small,
config.json), as one device of an expert-parallel deployment holds it:
written from the model's layer equations, the Mamba-2 paper's chunked SSD
(arXiv 2405.21060, `ssd_minimal_discrete`) and the BIP paper's Algorithm 1;
it imports nothing but torch and the minimind reference's RMSNorm, SwiGLU,
rounding, dual update and AdamW (`minimind_moe.py`, torch only too).

A step is: the token embedding times `embedding_multiplier`; per layer

    h = h + r * mixer(rmsnorm(h))                  r = residual_multiplier
    h = h + r * (moe(rmsnorm(h)) + shared(rmsnorm(h)))

with the mixer a Mamba-2 block or, where `attn_pattern` says 'global', causal
GQA attention with no position embedding (NoPE) and the scores times
`attn_scale`; then a final RMSNorm, the tied head over `logits_scaling`, and
mean next-token cross entropy.

Mamba-2 block: in_proj -> [z | x B C | dt]; a depthwise causal conv (with
bias) over (x, B, C), SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
the SSD y = SSM(x dt, A dt, B, C) + D x, in chunks of `ssm.chunk_size`
(intra-chunk quadratic form, chunk states, the inter-chunk recurrence, the
state-to-output term, as `ssd_minimal_discrete` computes them, in fp32);
y * silu(z) RMS-normed with its own scale; out_proj.

MoE FFN: the router scores all n_experts (softmax, fp32) and BIP's dual
(`minimind_moe.dual_update`, T = bip_iters) picks the top-k of s - q; the
gates are s of the chosen experts renormalised over them (Granite's softmax
over its top-k logits); capacity C = ceil(k n / m * capacity_factor) per
expert in token order. Only the experts whose weights the parameters hold
(`w_gate.shape[0]` of them, from `expert_offset`: the config's
`experts_held`, this device's share) are computed, and the layer's output
is their part: what the absent experts add lives on the other devices of
the deployment and is left out, as the program leaves it out. The shared
SwiGLU expert (width `shared_d_ff`) is added whole.

`precision` rounds the operands of every product the program computes in
its compute dtype (projections, the conv, attention scores and values,
experts, shared expert, head; the router and the SSD, fp32 in the program
too, stay fp32) and the gradients that flow back into them, as
`minimind_moe` does: 'fp8' is the control the comparison has to reject.
fp32 runs with TF32 off. Each layer is recomputed in its backward
(checkpoint), which changes no fp32 number.

Beside `train_steps`, what the harness reads: `leaf_specs` (the parameter
tree and its inits, the program's) and `model_flops_per_token` (what
`step_mfu` divides by). Every layer has a router, so `train_steps` records q
and the loads of every layer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .minimind_moe import ONE, _mm, _r, adamw_steps, dual_update, rmsnorm, swiglu

Tensor = torch.Tensor
ZERO = torch.tensor(0.0)  # a fixed init: the conv's bias, dt's bias


# ------------------------------------------------------------ layout, counts


def _mamba_dims(cfg: dict) -> Dict[str, int]:
    ssm = cfg["ssm"]
    di = ssm["expand"] * cfg["d_model"]
    n_heads = di // ssm["head_dim"]
    conv = di + 2 * ssm["n_groups"] * ssm["d_state"]
    return {"d_inner": di, "n_heads": n_heads, "conv_dim": conv, "in_proj": di + conv + n_heads}


def _held(cfg: dict) -> int:
    return cfg.get("experts_held") or cfg["routing"]["n_experts"]


def leaf_specs(cfg: dict) -> List[Tuple[tuple, tuple, object]]:
    """(keys from the root, shape, init) of every parameter, as the port's
    tree nests them and as the port initialises them: matrices 1/sqrt(fan_in),
    output projections further by 1/sqrt(2 L), the conv 0.5; RMSNorm scales
    and D ones, the conv's and dt's biases zero, A_log log(1..16) over the
    heads; the expert weights of the experts held here only."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    f, fs, v, n_layers = cfg["moe_d_ff"], cfg["shared_d_ff"], cfg["vocab_size"], cfg["n_layers"]
    m, held = cfg["routing"]["n_experts"], _held(cfg)
    md = _mamba_dims(cfg)
    di, nh = md["d_inner"], md["n_heads"]
    s_in, deep = 1.0 / math.sqrt(d), 1.0 / math.sqrt(2 * n_layers)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh))
    mamba = [
        (("pre_norm", "scale"), (d,), ONE),
        (("mamba", "in_proj"), (d, md["in_proj"]), s_in),
        (("mamba", "conv_w"), (cfg["ssm"]["d_conv"], md["conv_dim"]), 0.5),
        (("mamba", "conv_b"), (md["conv_dim"],), ZERO),
        (("mamba", "A_log"), (nh,), a_log),
        (("mamba", "D"), (nh,), ONE),
        (("mamba", "dt_bias"), (nh,), ZERO),
        (("mamba", "norm_scale"), (di,), ONE),
        (("mamba", "out_proj"), (di, d), deep / math.sqrt(di)),
    ]
    attention = [
        (("pre_norm", "scale"), (d,), ONE),
        (("attn", "wq"), (d, h, hd), s_in),
        (("attn", "wk"), (d, kv, hd), s_in),
        (("attn", "wv"), (d, kv, hd), s_in),
        (("attn", "wo"), (h, hd, d), s_in * deep),
    ]
    ffn = [
        (("ffn_norm", "scale"), (d,), ONE),
        (("moe", "w_router"), (d, m), s_in),
        (("moe", "w_gate"), (held, d, f), s_in),
        (("moe", "w_up"), (held, d, f), s_in),
        (("moe", "w_down"), (held, f, d), deep / math.sqrt(f)),
        (("shared_mlp", "w_gate"), (d, fs), s_in),
        (("shared_mlp", "w_up"), (d, fs), s_in),
        (("shared_mlp", "w_down"), (fs, d), deep / math.sqrt(fs)),
    ]
    out = [(("embed", "tok"), (v, d), s_in)]
    for i in range(n_layers):
        mixer = attention if _is_attention(cfg, i) else mamba
        out += [(("stack", "layers", i) + keys, shape, init) for keys, shape, init in mixer + ffn]
    out.append((("final_norm", "scale"), (d,), ONE))
    return out


def _is_attention(cfg: dict, i: int) -> bool:
    pattern = cfg["attn_pattern"]
    return pattern[i % len(pattern)] == "global"


def model_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward and backward model FLOPs of one token on this device: 6 per
    matmul parameter it uses, 3 times the forward FLOPs of the SSD's and
    attention's products between activations. Per term:

      mamba_proj   in_proj and out_proj of every Mamba layer
      ssd          per Mamba layer and token, in its chunk of Q: the
                   intra-chunk C B^T (once per group, the causal half:
                   G Q/2 N) and its product with x (H Q/2 P), the
                   chunk-state increment B x^T (H N P) and the
                   state-to-output C S (H N P), 2 FLOP a multiply-add
      attention    the attention layers' four projections, and causal
                   scores and values (2 S h hd per token forward, half of
                   the full square)
      shared       the shared expert and the router of every layer
      routed       the top-k's share that reaches the experts held here:
                   k * held / m experts a token (capacity drops not
                   counted)
      head         the tied head over the vocabulary slice

    No recomputation, no capacity padding, no conv or elementwise work."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    r = cfg["routing"]
    md = _mamba_dims(cfg)
    ssm = cfg["ssm"]
    q, n, p = min(ssm["chunk_size"], seq_len), ssm["d_state"], ssm["head_dim"]
    n_attn = sum(_is_attention(cfg, i) for i in range(cfg["n_layers"]))
    n_mamba = cfg["n_layers"] - n_attn
    terms = {
        "mamba_proj": 6.0 * n_mamba * (d * md["in_proj"] + md["d_inner"] * d),
        "ssd": 3.0 * n_mamba * 2 * (ssm["n_groups"] * q / 2 * n + md["n_heads"] * (q / 2 * p + 2 * n * p)),
        "attention": 6.0 * n_attn * (d * (h + 2 * kv) * hd + h * hd * d) + 6.0 * n_attn * seq_len * h * hd,
        "shared": 6.0 * cfg["n_layers"] * (3 * d * cfg["shared_d_ff"] + d * r["n_experts"]),
        "routed": 6.0 * cfg["n_layers"] * r["top_k"] * _held(cfg) / r["n_experts"] * 3 * d * cfg["moe_d_ff"],
        "head": 6.0 * d * cfg["vocab_size"],
    }
    return sum(terms.values())


# -------------------------------------------------------------------- mixers


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, prec: str) -> Tensor:
    """Depthwise causal conv of x (B, S, C) with taps w (K, C) and bias b,
    as torch.nn.Conv1d(C, C, K, groups=C, padding=K-1) truncated to S."""
    k, s = w.shape[0], x.shape[1]
    y = F.conv1d(_r(x, prec).transpose(1, 2), _r(w, prec).t()[:, None, :], _r(b, prec),
                 padding=k - 1, groups=x.shape[-1])
    return y[..., :s].transpose(1, 2)


def _segsum(x: Tensor) -> Tensor:
    """(..., T) -> (..., T, T): entry (i, j) the sum of x[j+1 .. i] for
    j <= i, -inf above the diagonal (exp gives the decay from j to i)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    x = x.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1), 0.0)
    seg = torch.cumsum(x, dim=-2)
    return seg.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device)), float("-inf"))


def ssd(x: Tensor, a: Tensor, b: Tensor, c: Tensor, block: int) -> Tensor:
    """The Mamba-2 paper's `ssd_minimal_discrete`: x (B, S, H, P) = x dt,
    a (B, S, H) = A dt, b and c (B, S, H, N); S a multiple of `block`.
    Returns y (B, S, H, P) from a zero initial state."""
    bsz, s, h, p = x.shape
    nc = s // block
    x, a, b, c = (t.reshape(bsz, nc, block, *t.shape[2:]) for t in (x, a, b, c))
    a = a.permute(0, 3, 1, 2)  # (B, H, nc, Q)
    a_cum = torch.cumsum(a, dim=-1)
    # 1. the intra-chunk (diagonal block) outputs
    decay = torch.exp(_segsum(a))  # (B, H, nc, Q, Q)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", c, b, decay, x)
    # 2. each chunk's final state from its own inputs
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", b, decay_states, x)
    # 3. the recurrence over chunks: the state entering each chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))  # (B, H, nc + 1, nc + 1)
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. the entering state's output inside each chunk
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", c, states, torch.exp(a_cum))
    return (y_diag + y_off).reshape(bsz, s, h, p)


def mamba(p: Dict[str, Tensor], x: Tensor, cfg: dict, prec: str) -> Tensor:
    """The Mamba-2 mixer over normed x (B, S, d)."""
    bsz, s, _ = x.shape
    ssm = cfg["ssm"]
    md = _mamba_dims(cfg)
    di, nh, g, n = md["d_inner"], md["n_heads"], ssm["n_groups"], ssm["d_state"]
    zxbcdt = _mm("bsd,de->bse", x, p["in_proj"], prec)
    z, xbc, dt = zxbcdt.split([di, md["conv_dim"], nh], dim=-1)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"], prec))
    xs, bs, cs = xbc.split([di, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, s, nh, ssm["head_dim"])
    # group j serves heads j * nh / g .. (j + 1) * nh / g - 1
    bs, cs = (t.reshape(bsz, s, g, 1, n).expand(bsz, s, g, nh // g, n).reshape(bsz, s, nh, n)
              for t in (bs, cs))
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    block = ssm["chunk_size"]
    pad = (-s) % block  # zero steps: no decay (a dt = 0) and no input
    xdt, adt, bs, cs = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                        for t in (xs * dt[..., None], a * dt, bs, cs))
    y = ssd(xdt, adt, bs, cs, block)[:, :s] + xs * p["D"][:, None]
    y = y.reshape(bsz, s, di) * F.silu(z)
    y = rmsnorm(y, p["norm_scale"], cfg["rms_norm_eps"])
    return _mm("bse,ed->bsd", y, p["out_proj"], prec)


def attention(p: Dict[str, Tensor], x: Tensor, cfg: dict, prec: str) -> Tensor:
    """Causal GQA attention with no position embedding; scores times
    attn_scale, query blocks of attn_chunk."""
    s = x.shape[1]
    q = _mm("bsd,dhk->bshk", x, p["wq"], prec)
    k = _mm("bsd,dhk->bshk", x, p["wk"], prec)
    v = _mm("bsd,dhk->bshk", x, p["wv"], prec)
    groups = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)
    pos = torch.arange(s, device=x.device)
    chunk = min(cfg["attn_chunk"], s)
    ys = []
    for c0 in range(0, s, chunk):
        qi = q[:, c0:c0 + chunk]
        scores = _mm("bqhd,bkhd->bhqk", qi, k, prec) * cfg["attn_scale"]
        causal = pos[c0:c0 + qi.shape[1], None] >= pos[None, :]
        w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        ys.append(_mm("bhqk,bkhd->bqhd", w, v, prec))
    return _mm("bshk,hkd->bsd", torch.cat(ys, dim=1), p["wo"], prec)


# ----------------------------------------------------------------------- MoE


def moe(p: Dict[str, Tensor], x: Tensor, q_prev: Tensor, cfg: dict, strategy: str, prec: str,
        expert_offset: int = 0):
    """Routed experts over tokens x (n, d): the part of the output that the
    experts held in `p` (expert_offset onwards) give. Returns (y, q, load)
    with load over all n_experts."""
    n, d = x.shape
    r = cfg["routing"]
    m, k = r["n_experts"], r["top_k"]
    held = p["w_gate"].shape[0]
    s = torch.softmax(x @ p["w_router"], dim=-1)
    if strategy == "bip":
        q = dual_update(s.detach(), q_prev, k, r["bip_iters"])
    elif strategy == "topk":
        q = torch.zeros_like(q_prev)
    else:
        raise ValueError(f"the reference routes by 'bip' or 'topk', not {strategy!r}")
    idx = torch.sort(s.detach() - q[None, :], dim=-1, descending=True, stable=True).indices[:, :k]
    w = s.gather(1, idx)
    if r["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    load = torch.bincount(idx.reshape(-1), minlength=m)
    cap = max(math.ceil(k * n / m * r["capacity_factor"]), 1)
    flat = idx.reshape(-1)  # (n k,): token-major, slot order within a token
    order = torch.sort(flat, stable=True).indices
    starts = torch.cumsum(load, 0) - load
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(n * k, device=x.device) - starts[flat[order]]
    here = (pos < cap) & (flat >= expert_offset) & (flat < expert_offset + held)
    kept = torch.nonzero(here)[:, 0]
    slot = (flat[kept] - expert_offset) * cap + pos[kept]
    buf = torch.zeros(held * cap, d, device=x.device).index_put((slot,), x[kept // k])
    y = swiglu(buf.view(held, cap, d), p["w_gate"], p["w_up"], p["w_down"], prec,
               spec=("ecd,edf->ecf", "ecf,efd->ecd")).reshape(held * cap, d)
    contrib = torch.zeros(n * k, d, device=x.device).index_put((kept,), y[slot] * w.reshape(-1)[kept, None])
    return contrib.view(n, k, d).sum(dim=1), q, load


def ffn(lp: Dict[str, Dict[str, Tensor]], xn: Tensor, q_prev: Tensor, cfg: dict, strategy: str, prec: str):
    """The routed experts held here plus the shared expert over normed xn
    (B, S, d): (y, q, load)."""
    b, s, d = xn.shape
    y, q, load = moe(lp["moe"], xn.reshape(b * s, d), q_prev, cfg, strategy, prec)
    sh = lp["shared_mlp"]
    return y.view(b, s, d) + swiglu(xn, sh["w_gate"], sh["w_up"], sh["w_down"], prec), q, load


def _layer(x, lp, q_prev, cfg, strategy, prec, is_attention: bool):
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    xn = rmsnorm(x, lp["pre_norm"]["scale"], eps)
    x = x + rm * (attention(lp["attn"], xn, cfg, prec) if is_attention else mamba(lp["mamba"], xn, cfg, prec))
    y, q, load = ffn(lp, rmsnorm(x, lp["ffn_norm"]["scale"], eps), q_prev, cfg, strategy, prec)
    return x + rm * y, q, load


def loss_fn(params, tokens: Tensor, labels: Tensor, qs: List[Tensor], cfg: dict, strategy: str, prec: str):
    """Mean next-token cross entropy; returns (loss, new qs, loads (L, m))."""
    x = params["embed"]["tok"][tokens] * cfg["embedding_multiplier"]
    new_q, loads = [], []
    for i, (lp, q_prev) in enumerate(zip(params["stack"]["layers"], qs)):
        # layer by layer under checkpoint: one layer's activations live at a time
        x, q, load = checkpoint(_layer, x, lp, q_prev, cfg, strategy, prec, _is_attention(cfg, i),
                                use_reentrant=False)
        new_q.append(q)
        loads.append(load)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    logits = _mm("bsd,vd->bsv", x, params["embed"]["tok"], prec) / cfg["logits_scaling"]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return loss, new_q, torch.stack(loads)


def train_steps(params, batches, cfg: dict, mix: dict, precision: str = "fp32") -> Dict[str, list]:
    """len(batches) training steps from `params` and zero duals
    (minimind_moe.adamw_steps: AdamW, clipping, decay on every leaf but the
    final norm), recording each layer's q and loads."""
    strategy = mix["routing"]["strategy"]
    m = cfg["routing"]["n_experts"]
    qs = [torch.zeros(m, device=params["embed"]["tok"].device) for _ in params["stack"]["layers"]]

    def loss_step(batch):
        nonlocal qs
        loss, qs, load = loss_fn(params, batch["tokens"], batch["labels"], qs, cfg, strategy, precision)
        return loss, {"q": torch.stack(qs), "load": load}

    return adamw_steps(params, batches, mix, loss_step)
