"""Routing core of the port: BIP duals (the exact and the bisection forms,
and the reference's Algorithm 1 gate `bip_route_reference`), the balancer
registry (topk, aux_loss, lossfree, bip, phi, lpr, expert_choice), router,
dispatch plan, the paper's streaming gates (Algorithms 3 and 4) and the LP
oracle."""
from repro_torch.core.approx import ApproxBIPGate
from repro_torch.core.balancers import (
    Balancer,
    get_balancer,
    register_balancer,
    registered_balancers,
)
from repro_torch.core.expert_choice import expert_choice_route, expert_choice_select
from repro_torch.core.lp_oracle import greedy_balanced_objective, routing_objective, solve_plp
from repro_torch.core.metrics import BalanceTracker, balance_metrics, expert_load, max_violation
from repro_torch.core.online import OnlineBIPGate
from repro_torch.core.ref_bip import (
    bip_dual_update,
    bip_dual_update_global,
    bip_dual_update_masked,
    bip_dual_update_threshold,
    bip_route_reference,
    bip_topk,
    bisect_rounds,
    kth_largest,
    kth_largest_threshold,
)
from repro_torch.core.router import (
    DispatchPlan,
    compute_scores,
    make_dispatch_plan,
    route,
)
from repro_torch.core.types import RouterConfig, RouterOutput, init_router_state

__all__ = [
    "ApproxBIPGate",
    "Balancer",
    "BalanceTracker",
    "DispatchPlan",
    "OnlineBIPGate",
    "RouterConfig",
    "RouterOutput",
    "balance_metrics",
    "bip_dual_update",
    "bip_dual_update_global",
    "bip_dual_update_masked",
    "bip_dual_update_threshold",
    "bip_route_reference",
    "bip_topk",
    "bisect_rounds",
    "compute_scores",
    "expert_choice_route",
    "expert_choice_select",
    "expert_load",
    "get_balancer",
    "greedy_balanced_objective",
    "init_router_state",
    "kth_largest",
    "kth_largest_threshold",
    "make_dispatch_plan",
    "max_violation",
    "register_balancer",
    "registered_balancers",
    "route",
    "routing_objective",
    "solve_plp",
]
