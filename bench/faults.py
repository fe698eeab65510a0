"""Faults planted in the program's timed path, each a wrapper of the train
step, to see the comparison reject them (bench/tests, bench/calibrate.py):

  unchanged   the step returns its state as it found it
  half_batch  the step sees the first half of the batch's rows, its loss
              the mean over those
  grad        one leaf's gradient doubled where the backward hands it to
              AdamW (the answer altered where it is produced)

A run on one card has no exchange between cards to leave out.
"""
from __future__ import annotations

import torch


def _tensors(state):
    from repro_torch.optim.adamw import tree_leaves

    return tree_leaves([state.params, state.opt_state["mu"], state.opt_state["nu"], state.router_states])


def unchanged(step):
    def run(state, batch):
        saved = [t.detach().clone() for t in _tensors(state)]
        count = state.opt_state["step"]
        state, mets = step(state, batch)
        with torch.no_grad():
            for t, s in zip(_tensors(state), saved):
                t.copy_(s)
        state.opt_state["step"] = count
        return state, mets
    return run


def half_batch(step):
    def run(state, batch):
        rows = next(iter(batch.values())).shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()})
    return run


def grad(step):
    from repro_torch.training import loop

    real = loop._adamw.adamw_update

    def doubled(grads, *args, **kwargs):
        grads = list(grads)
        grads[len(grads) // 2] = 2 * grads[len(grads) // 2]
        return real(grads, *args, **kwargs)

    def run(state, batch):
        loop._adamw.adamw_update = doubled
        try:
            return step(state, batch)
        finally:
            loop._adamw.adamw_update = real
    return run


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "grad": grad}
