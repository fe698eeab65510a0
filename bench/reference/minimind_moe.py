"""Plain PyTorch reference of BIP-balanced pre-training of the minimind MoE
models (minimind-moe-16e / 64e [paper Table 1]), written from the model's
equations and the paper's Algorithm 1; it imports nothing but torch.

A step is: token embedding; per layer, a pre-norm residual block of causal
multi-head attention (RoPE on split halves) and a pre-norm residual block
of routed experts beside a shared expert; a final RMSNorm and the tied head;
mean next-token cross entropy. Routing: softmax scores s (fp32 router), the
dual price q from T ADMM iterations warm-started from the last step's q,
top-k of s - q (ties to the lower expert), gate weights the raw s, static
capacity C = ceil(k n / m * capacity_factor) with each expert's queue in
token order (slot order within a token), tokens past C dropped. Then AdamW
with global-norm clipping, weight decay on every leaf but the final norm.

The dual's column order statistic is the histogram form the configuration
runs (512 bins over [-1, 1), one refining pass over the located bin, q
interpolated in its bin): counts are exact integers here, taken by sorting
each expert's column and searching the bin edges.

`precision` rounds the operands of every product the model computes in its
compute dtype (projections, attention scores and values, experts, shared
expert, head; the router stays fp32) and the gradients that flow back into
them: 'fp32' leaves them as they are, 'bf16' rounds to bfloat16, 'fp8'
to float8 e4m3 with one scale per tensor (amax to 448). The fp8 form is the
control that the comparison has to reject. fp32 runs with TF32 off.

Beside `train_steps`, the facts about this model that the harness reads:
`leaf_specs` (the parameter tree and how each leaf is drawn) and
`model_flops_per_token` (the count `step_mfu` divides by). Every layer has a
router, so `train_steps` records q and the loads of every layer.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor

N_BINS = 512
REFINE = 1
FP8_MAX = 448.0  # largest finite float8 e4m3fn
ONE = torch.tensor(1.0)  # a fixed init (leaf_specs): an RMSNorm's scale


# ------------------------------------------------------------ layout, counts


def leaf_specs(cfg: dict) -> List[Tuple[tuple, tuple, object]]:
    """(keys from the root, shape, init: a normal draw's scale or a fixed
    value) of every parameter, as the port's tree nests them and as the port
    initialises them (1/sqrt(fan_in); output projections further by
    1/sqrt(2 L); RMSNorm scales 1)."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    f, n_layers, v = cfg["moe_d_ff"], cfg["n_layers"], cfg["vocab_size"]
    m = cfg["routing"]["n_experts"]
    fs = f * cfg["n_shared_experts"]
    s_in, deep = 1.0 / math.sqrt(d), 1.0 / math.sqrt(2 * n_layers)
    layer = [
        (("pre_norm", "scale"), (d,), ONE),
        (("attn", "wq"), (d, h, hd), s_in),
        (("attn", "wk"), (d, kv, hd), s_in),
        (("attn", "wv"), (d, kv, hd), s_in),
        (("attn", "wo"), (h, hd, d), s_in * deep),
        (("ffn_norm", "scale"), (d,), ONE),
        (("moe", "w_router"), (d, m), s_in),
        (("moe", "w_gate"), (m, d, f), s_in),
        (("moe", "w_up"), (m, d, f), s_in),
        (("moe", "w_down"), (m, f, d), deep / math.sqrt(f)),
        (("shared_mlp", "w_gate"), (d, fs), s_in),
        (("shared_mlp", "w_up"), (d, fs), s_in),
        (("shared_mlp", "w_down"), (fs, d), deep / math.sqrt(fs)),
    ]
    out = [(("embed", "tok"), (v, d), s_in)]
    out += [(("stack", "layers", i) + keys, shape, init)
            for i in range(n_layers) for keys, shape, init in layer]
    out.append((("final_norm", "scale"), (d,), ONE))
    return out


def active_matmul_params(cfg: dict) -> int:
    """Matmul parameters one token uses: attention's four projections, its
    top-k experts, the shared experts and the router in every layer, and
    the tied head."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    r = cfg["routing"]
    attn = d * (h + 2 * kv) * hd + h * hd * d
    experts = (r["top_k"] + cfg["n_shared_experts"]) * 3 * d * cfg["moe_d_ff"]
    per_layer = attn + experts + d * r["n_experts"]
    return cfg["n_layers"] * per_layer + d * cfg["vocab_size"]


def model_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward and backward model FLOPs of one token: 6 per matmul parameter
    it uses, plus causal attention's scores and values, 6 L S d (half of the
    full 12 L S d). No recomputation, no capacity padding."""
    return 6.0 * active_matmul_params(cfg) + 6.0 * cfg["n_layers"] * seq_len * cfg["d_model"]


def _round(t: Tensor, precision: str) -> Tensor:
    if precision == "fp32":
        return t
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


class _Rounded(torch.autograd.Function):
    """Rounds a product's operand on the way in and its gradient on the way back."""

    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return _round(t, precision)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision), None


def _r(t: Tensor, precision: str) -> Tensor:
    return t if precision == "fp32" else _Rounded.apply(t, precision)


def _mm(spec: str, a: Tensor, b: Tensor, precision: str) -> Tensor:
    return torch.einsum(spec, _r(a, precision), _r(b, precision))


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: Tensor, theta: float) -> Tensor:
    """x (B, S, H, D) at positions 0..S-1: (x1, x2) halves rotated."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[None, :, None, :], torch.cos(ang)[None, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: Dict[str, Tensor], x: Tensor, cfg: dict, prec: str) -> Tensor:
    b, s, _ = x.shape
    q = rope(_mm("bsd,dhk->bshk", x, p["wq"], prec), cfg["rope_theta"])
    k = rope(_mm("bsd,dhk->bshk", x, p["wk"], prec), cfg["rope_theta"])
    v = _mm("bsd,dhk->bshk", x, p["wv"], prec)
    groups = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)
    pos = torch.arange(s, device=x.device)
    chunk = min(cfg["attn_chunk"], s)  # query blocks bound the (B, H, chunk, S) scores
    ys = []
    for c0 in range(0, s, chunk):
        qi = q[:, c0:c0 + chunk]
        scores = _mm("bqhd,bkhd->bhqk", qi, k, prec) / math.sqrt(q.shape[-1])
        causal = pos[c0:c0 + qi.shape[1], None] >= pos[None, :]
        w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        ys.append(_mm("bhqk,bkhd->bqhd", w, v, prec))
    return _mm("bshk,hkd->bsd", torch.cat(ys, dim=1), p["wo"], prec)


def swiglu(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor, prec: str, spec=("...d,df->...f", "...f,fd->...d")):
    h = F.silu(_mm(spec[0], x, wg, prec)) * _mm(spec[0], x, wu, prec)
    return _mm(spec[1], h, wd, prec)


# ------------------------------------------------------------------ BIP dual


def _counts_above(sorted_cols: Tensor, edges: Tensor) -> Tensor:
    """#{values > edge} per expert and edge; sorted_cols (m, n) ascending."""
    n = sorted_cols.shape[1]
    return (n - torch.searchsorted(sorted_cols, edges.contiguous(), right=True)).float()


def dual_update(s: Tensor, q0: Tensor, top_k: int, n_iters: int) -> Tensor:
    """T ADMM dual iterations (Algorithm 1) on scores s (n, m) from q0 (m,):
    p_i = max(0, (k+1)-th largest of s_i - q); q_j = max(0, the (nk/m + 1)-th
    largest of s_:j - p), that order statistic read from histograms of
    N_BINS bins over [-1, 1), refined REFINE times inside the located bin,
    and interpolated linearly in its bin."""
    n, m = s.shape
    rank = (n * top_k) // m
    if rank >= n:  # capacity slack: the constraint never binds
        return torch.zeros_like(q0)
    frac = torch.arange(N_BINS, dtype=torch.float32, device=s.device) / N_BINS
    q = q0.float()
    for _ in range(n_iters):
        if top_k + 1 > m:
            p = torch.zeros(n, device=s.device)
        else:
            p = torch.clamp_min(torch.topk(s - q[None, :], top_k + 1, dim=1).values[:, top_k], 0.0)
        cols = torch.sort((s - p[:, None]).t().contiguous(), dim=1).values
        lo = torch.full((m,), -1.0, device=s.device)
        hi = torch.full((m,), 1.0, device=s.device)
        for _ in range(REFINE + 1):
            cnt = _counts_above(cols, lo[:, None] + (hi - lo)[:, None] * frac[None, :])
            width = (hi - lo) / N_BINS
            b_star = (cnt > rank).sum(dim=1) - 1
            found = b_star >= 0
            b = torch.clamp(b_star, 0, N_BINS - 1)
            bin_lo = lo + b.float() * width
            last_lo, last_width = lo, width
            lo = torch.where(found, bin_lo, lo)
            hi = torch.where(found, bin_lo + width, hi)
        # q from the last pass's counts, in the bin they locate
        c_lo = cnt.gather(1, b[:, None])[:, 0]
        c_next = cnt.gather(1, torch.clamp(b + 1, max=N_BINS - 1)[:, None])[:, 0]
        c_hi = torch.where(b + 1 < N_BINS, c_next, torch.zeros_like(c_next))
        t = torch.clamp((c_lo - rank) / torch.clamp_min(c_lo - c_hi, 1.0), 0.0, 1.0)
        v = (last_lo + b.float() * last_width) + t * last_width
        q = torch.where(found, torch.clamp_min(v, 0.0), torch.zeros_like(v))
    return q


# ----------------------------------------------------------------------- MoE


def moe(p: Dict[str, Tensor], x: Tensor, q_prev: Tensor, cfg: dict, strategy: str, prec: str):
    """Routed experts over tokens x (n, d). Returns (y, q, load)."""
    n, d = x.shape
    r = cfg["routing"]
    m, k = r["n_experts"], r["top_k"]
    s = torch.softmax(x @ p["w_router"], dim=-1)
    if strategy == "bip":
        q = dual_update(s.detach(), q_prev, k, r["bip_iters"])
    elif strategy == "topk":
        q = torch.zeros_like(q_prev)
    else:
        raise ValueError(f"the reference routes by 'bip' or 'topk', not {strategy!r}")
    idx = torch.sort(s.detach() - q[None, :], dim=-1, descending=True, stable=True).indices[:, :k]
    w = s.gather(1, idx)
    load = torch.bincount(idx.reshape(-1), minlength=m)
    cap = max(math.ceil(k * n / m * r["capacity_factor"]), 1)
    flat = idx.reshape(-1)  # (n k,): token-major, slot order within a token
    order = torch.sort(flat, stable=True).indices
    starts = torch.cumsum(load, 0) - load
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(n * k, device=x.device) - starts[flat[order]]
    kept = torch.nonzero(pos < cap)[:, 0]
    slot = flat[kept] * cap + pos[kept]
    buf = torch.zeros(m * cap, d, device=x.device).index_put((slot,), x[kept // k])
    y = swiglu(buf.view(m, cap, d), p["w_gate"], p["w_up"], p["w_down"], prec,
               spec=("ecd,edf->ecf", "ecf,efd->ecd")).reshape(m * cap, d)
    contrib = torch.zeros(n * k, d, device=x.device).index_put((kept,), y[slot] * w.reshape(-1)[kept, None])
    return contrib.view(n, k, d).sum(dim=1), q, load


def _layer(x, lp, q_prev, cfg, strategy, prec):
    b, s, d = x.shape
    eps = cfg["rms_norm_eps"]
    x = x + attention(lp["attn"], rmsnorm(x, lp["pre_norm"]["scale"], eps), cfg, prec)
    xn = rmsnorm(x, lp["ffn_norm"]["scale"], eps)
    y, q, load = moe(lp["moe"], xn.reshape(b * s, d), q_prev, cfg, strategy, prec)
    sh = lp["shared_mlp"]
    y = y.view(b, s, d) + swiglu(xn, sh["w_gate"], sh["w_up"], sh["w_down"], prec)
    return x + y, q, load


def loss_fn(params, tokens: Tensor, labels: Tensor, qs: List[Tensor], cfg: dict, strategy: str, prec: str):
    """Mean next-token cross entropy; returns (loss, new qs, loads (L, m))."""
    x = params["embed"]["tok"][tokens]
    new_q, loads = [], []
    for lp, q_prev in zip(params["stack"]["layers"], qs):
        # layer by layer under checkpoint: one layer's activations live at a time
        x, q, load = checkpoint(_layer, x, lp, q_prev, cfg, strategy, prec, use_reentrant=False)
        new_q.append(q)
        loads.append(load)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    logits = _mm("bsd,vd->bsv", x, params["embed"]["tok"], prec)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return loss, new_q, torch.stack(loads)


# --------------------------------------------------------------------- AdamW


def leaves(tree, prefix=""):
    """(path, tensor) pairs, dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def lr_at(step: int, peak: float, warmup: int, total: int, final_frac: float = 0.1) -> float:
    """Linear warm-up over `warmup` steps, then cosine to final_frac * peak."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (final_frac + (1.0 - final_frac) * 0.5 * (1.0 + math.cos(math.pi * t)))


def adamw_steps(params, batches, mix: dict, loss_step: Callable) -> Dict[str, list]:
    """len(batches) AdamW steps from `params` (a tree of fp32 tensors,
    updated in place), TF32 off. `loss_step(batch)` gives the step's loss
    and what the step records beside it ({'q': (L, m), 'load': (L, m)} of
    the layers with a router; {} where none has one). Returns per step
    'loss' (float), 'q' and 'load'; 'grad_norms' of each leaf's gradient
    after clipping at step 1, and 'update_norms' of each leaf's change over
    all the steps (leaves in `leaves` order). Weight decay on every leaf but
    the final norm."""
    opt = mix["adamw"]
    named = leaves(params)
    ps = [t for _, t in named]
    decay = [not path.startswith("final_norm") for path, _ in named]
    p0 = [t.detach().clone() for t in ps]
    mu = [torch.zeros_like(t) for t in ps]
    nu = [torch.zeros_like(t) for t in ps]
    out = {"loss": [], "q": [], "load": [], "grad_norms": None}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for step, batch in enumerate(batches):
            for t in ps:
                t.requires_grad_(True)
            loss, recorded = loss_step(batch)
            grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(opt["clip_norm"] / torch.clamp_min(gnorm, 1e-9), max=1.0)
                grads = [g * scale for g in grads]
                if step == 0:
                    out["grad_norms"] = torch.stack([torch.linalg.vector_norm(g) for g in grads]).tolist()
                lr = lr_at(step, mix["lr"], mix["warmup_steps"], mix["total_steps"])
                b1, b2 = opt["b1"], opt["b2"]
                c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
                for p, g, mu_i, nu_i, dec in zip(ps, grads, mu, nu, decay):
                    mu_i.mul_(b1).add_(g, alpha=1 - b1)
                    nu_i.mul_(b2).add_(g * g, alpha=1 - b2)
                    delta = (mu_i / c1) / (torch.sqrt(nu_i / c2) + opt["eps"])
                    if dec and opt["weight_decay"] > 0:
                        delta = delta + opt["weight_decay"] * p
                    p.sub_(lr * delta)
            out["loss"].append(float(loss.detach()))
            for key, value in recorded.items():
                out[key].append(value.cpu())
        with torch.no_grad():
            out["update_norms"] = torch.stack(
                [torch.linalg.vector_norm(p - p_0) for p, p_0 in zip(ps, p0)]).tolist()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        for t in ps:
            t.requires_grad_(False)
    return out


def train_steps(params, batches, cfg: dict, mix: dict, precision: str = "fp32") -> Dict[str, list]:
    """len(batches) training steps from `params` and zero duals (adamw_steps),
    recording each layer's q and loads."""
    strategy = mix["routing"]["strategy"]
    m = cfg["routing"]["n_experts"]
    qs = [torch.zeros(m, device=params["embed"]["tok"].device) for _ in params["stack"]["layers"]]

    def loss_step(batch):
        nonlocal qs
        loss, qs, load = loss_fn(params, batch["tokens"], batch["labels"], qs, cfg, strategy, precision)
        return loss, {"q": torch.stack(qs), "load": load}

    return adamw_steps(params, batches, mix, loss_step)
