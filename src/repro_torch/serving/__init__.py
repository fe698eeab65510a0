"""Continuous-batching serving of the port, and batched greedy decoding."""
from repro_torch.serving.engine import ContinuousBatchingEngine, greedy_generate
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ContinuousBatchingEngine", "Request", "Scheduler", "greedy_generate"]
