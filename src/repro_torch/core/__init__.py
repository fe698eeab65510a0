"""Routing core of the port: BIP duals, balancers, router, dispatch plan."""
from repro_torch.core.balancers import get_balancer, registered_balancers
from repro_torch.core.router import (
    DispatchPlan,
    compute_scores,
    make_dispatch_plan,
    route,
)
from repro_torch.core.types import RouterConfig, RouterOutput, init_router_state

__all__ = [
    "DispatchPlan",
    "RouterConfig",
    "RouterOutput",
    "compute_scores",
    "get_balancer",
    "init_router_state",
    "make_dispatch_plan",
    "registered_balancers",
    "route",
]
