"""granite-4.0-h-small on the port: Mamba-2 layers that carry a MoE FFN
(models/stack.py's ('mamba', 'moe') layers), NoPE attention with Granite's
scale, the embedding / residual / logits multipliers, the shared expert's
own width and one device's share of the experts (cfg.experts_held), held
against the benchmark's plain reference (bench/reference/granite_moe_hybrid.py,
plain fp32 torch written from the published layer equations and the Mamba-2
paper's chunked SSD) on the CPU at a small size: the whole period of ten
layers at width 64, 16 experts with 2 held, top-4, chunks of 8.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's reference lives beside src/
    sys.path.insert(0, str(ROOT))

from bench import inputs  # noqa: E402
from bench.reference import granite_moe_hybrid as ref  # noqa: E402
from bench.reference.minimind_moe import leaves  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SSMSpec  # noqa: E402
from repro_torch.models import moe, stack  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_paths  # noqa: E402

M, HELD = 16, 2


def _cfg(**kw):
    base = configs.get("granite-4.0-h-small")
    small = dict(
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, moe_d_ff=32, shared_d_ff=48,
        vocab_size=256, experts_held=HELD, attn_chunk=16, max_seq_len=256,
        routing=dataclasses.replace(base.routing, n_experts=M, top_k=4, bip_iters=4, use_kernel=True),
        ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk_size=8),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
    small.update(kw)
    return dataclasses.replace(base, **small)


def _ref_cfg(cfg) -> dict:
    """The port's config as the reference reads it (the benchmark's file layout)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["routing"] = dataclasses.asdict(cfg.routing)
    out["ssm"] = dataclasses.asdict(cfg.ssm)
    return out


def _batch(seed=1, b=2, s=32, vocab=256):
    tok = torch.randint(0, vocab, (b, s + 1), generator=torch.Generator().manual_seed(seed))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def test_loss_and_grads_match_reference():
    """One step's loss, every leaf's gradient, each layer's dual and loads,
    port against reference from the same seeded weights, fp32 on both sides
    (K3's and K1/K2's plain versions on the CPU). Tolerances: the loss to
    1e-6 relative and each leaf's gradient to 1e-4 of its norm (the norm of
    the difference): the two compute the same fp32 products in different
    orders and groupings (the chunked SSD's quadratic and state terms,
    ssd_chunked against the paper's ssd_minimal_discrete; attention's query
    blocks; the dispatch), which over ten layers and the backward reads
    1.7e-7 (loss) and at most 9.2e-6 (the gradient of a layer's A_log) at
    this seed. q and the loads must be equal: routing that parts on a tie
    at this size would move whole gradients, not round them."""
    cfg = _cfg()
    rc = _ref_cfg(cfg)
    batch = _batch()
    params = inputs.make_params(ref.leaf_specs(rc), 0, "cpu")
    ps = tree_leaves(params)
    for t in ps:
        t.requires_grad_(True)
    model = Model(cfg, device="cpu")
    loss, (states, mets) = model.loss_fn(params, batch, model.init_router_states())
    grads = torch.autograd.grad(loss, ps)

    rparams = inputs.make_params(ref.leaf_specs(rc), 0, "cpu")
    rps = [t.requires_grad_(True) for _, t in leaves(rparams)]
    qs = [torch.zeros(M) for _ in range(cfg.n_layers)]
    rloss, rq, rload = ref.loss_fn(rparams, batch["tokens"], batch["labels"], qs, rc, "bip", "fp32")
    rgrads = torch.autograd.grad(rloss, rps)

    assert [p for p, _ in tree_paths(params)] == [p for p, _ in leaves(rparams)]
    assert abs(float(loss.detach()) - float(rloss.detach())) <= 1e-6 * abs(float(rloss.detach()))
    for (path, _), g, rg in zip(tree_paths(params), grads, rgrads):
        assert float((g - rg).norm()) <= 1e-4 * float(rg.norm()), path
    assert torch.equal(torch.stack([st["q"] for st in states]), torch.stack(rq))
    assert torch.equal(mets["load_per_layer"], rload)


def test_expert_shares_add_up_to_the_whole_layer():
    """The 8 devices' shares of one MoE layer (experts o .. o + 1 for o in
    0, 2, .., 14, each computed by the port's one-device layer as a device
    holding them would), with the shared expert counted once, add up to the
    reference's uncut layer (all 16 experts held). fp32; the sum of eight
    partial sums against one: 1e-5 of the largest entry."""
    whole = _ref_cfg(_cfg(experts_held=0))
    lp = inputs.make_params(ref.leaf_specs(whole), 3, "cpu")["stack"]["layers"][0]
    xn = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(4))
    want, q, load = ref.ffn(lp, xn, torch.zeros(M), whole, "bip", "fp32")

    cfg = _cfg()
    state = stack.init_stack_router_states(cfg)[0]
    got = stack._residual_mlps(lp, xn, cfg)  # the shared expert, once
    for o in range(0, M, HELD):
        share = dict(lp["moe"], **{k: lp["moe"][k][o:o + HELD] for k in ("w_gate", "w_up", "w_down")})
        y, new_state, _, mets = moe.moe_ffn_local(share, xn.reshape(-1, 64), state, cfg, expert_offset=o)
        got = got + y.view(xn.shape)
        assert torch.equal(new_state["q"], q) and torch.equal(mets["load"], load)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_registry_and_layer_kinds():
    cfg = configs.get("granite-4.0-h-small")
    assert configs.get("granite_4_0_h_small") is cfg
    assert "granite_4_0_h_small" in configs.PORT_IDS
    assert "granite_4_0_h_small" not in configs.ARCH_IDS and "granite_4_0_h_small" not in configs.all_configs()
    assert "granite-4.0-h-small" not in configs.CLI_ALIASES
    stack.check_supported(cfg)
    kinds = cfg.layer_kinds()
    assert cfg.scan_period() == 10 and len(kinds) == 40
    assert [i for i, (mixer, _) in enumerate(kinds) if mixer == "global"] == [5, 15, 25, 35]
    assert {ffn for _, ffn in kinds} == {"moe"}
    assert (cfg.n_experts_held, stack.shared_width(cfg)) == (72, 1536)


def test_held_share_and_serving_refusal():
    """The model holds the expert weights of its share only, and the cached
    serving path, which has none of the new fields, refuses the model."""
    cfg = _cfg()
    model = Model(cfg, device="cpu")
    params = model.init(0)
    layer = params["stack"]["layers"][0]
    assert layer["moe"]["w_gate"].shape == (HELD, 64, 32) and layer["moe"]["w_router"].shape == (64, M)
    assert layer["shared_mlp"]["w_down"].shape == (48, 64) and "mamba" in layer
    with pytest.raises(NotImplementedError, match="trains such a model only"):
        model.init_slot_cache(params, 2, 64)


def test_ssd_span_and_its_twin():
    """Under the profiler, each Mamba layer's SSD runs once as 'mamba/ssd'
    inside 'model/mamba', and its backward once as 'bwd/mamba/ssd'."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(n_layers=3, attn_pattern=("mamba", "global", "mamba"))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    ps = tree_leaves(params)
    for t in ps:
        t.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = model.loss_fn(params, _batch(s=16), model.init_router_states())
        torch.autograd.grad(loss, ps)
    events = list(prof.events())
    names = [e.name for e in events]
    assert names.count("mamba/ssd") == 2 and names.count("bwd/mamba/ssd") == 2
    for e in events:
        if e.name == "mamba/ssd":
            parent = e.cpu_parent
            while parent is not None and parent.name != "model/mamba":
                parent = parent.cpu_parent
            assert parent is not None
