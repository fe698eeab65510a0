"""Continuous-batching serving of the port."""
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ContinuousBatchingEngine", "Request", "Scheduler"]
