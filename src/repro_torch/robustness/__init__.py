"""Fault tolerance of the port (copies of src/repro/robustness): the
fault-injection registry and the anomaly-guard ladder.

`faults` makes failures reproducible (seeded injectors for NaN grads,
checkpoint bitrot, flaky shards, stalled prefetch, slow serve steps);
`guards` makes recovery deterministic (skip -> reduce-LR -> rollback
ladder over the guarded train step's state select). See DESIGN.md
§Robustness.
"""
from repro_torch.robustness.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    corrupt_file,
    parse_fault,
)
from repro_torch.robustness.guards import (  # noqa: F401
    GuardConfig,
    TrainGuard,
    TrainingDiverged,
)

__all__ = [
    "Fault",
    "FaultPlan",
    "GuardConfig",
    "TrainGuard",
    "TrainingDiverged",
    "corrupt_file",
    "parse_fault",
]
