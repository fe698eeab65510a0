"""Exact LP-relaxation oracle for the assignment problem (test-time only;
the port's copy of src/repro/core/lp_oracle.py: numpy + scipy, inputs may
be numpy arrays or torch tensors on any device).

Solves (P-LP) from the paper with scipy.optimize.linprog (HiGHS):

    max Σ s_ij x_ij   s.t.  Σ_j x_ij <= k,  Σ_i x_ij <= kn/m,  0 <= x <= 1.

Used by tests/benchmarks to measure how close the ADMM-iterated routing gets
to the true optimum (objective ratio), and to check that the primal solution
recovered from the dual prices matches complementary slackness.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def as_numpy(a) -> np.ndarray:
    """A numpy view of `a`: a numpy array or sequence as it is, a torch
    tensor (any device) copied to the host."""
    if hasattr(a, "detach"):  # a torch tensor; duck-typed so numpy callers need no torch
        return a.detach().cpu().numpy()
    return np.asarray(a)


def solve_plp(s: np.ndarray, top_k: int) -> Tuple[np.ndarray, float]:
    """Returns (x (n,m) in [0,1], optimal objective value)."""
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    s = as_numpy(s)
    n, m = s.shape
    cap = top_k * n / m
    nv = n * m
    a = lil_matrix((n + m, nv))
    for i in range(n):  # row constraints: sum_j x_ij <= k
        a[i, i * m : (i + 1) * m] = 1.0
    for j in range(m):  # column constraints: sum_i x_ij <= kn/m
        a[n + j, j::m] = 1.0
    b = np.concatenate([np.full(n, float(top_k)), np.full(m, cap)])
    res = linprog(
        c=-s.reshape(-1),
        A_ub=a.tocsr(),
        b_ub=b,
        bounds=(0.0, 1.0),
        method="highs",
    )
    if not res.success:
        raise RuntimeError(f"linprog failed: {res.message}")
    return res.x.reshape(n, m), -res.fun


def routing_objective(s: np.ndarray, expert_index: np.ndarray) -> float:
    """Σ s_ij over the selected (token, expert) pairs."""
    s, expert_index = as_numpy(s), as_numpy(expert_index)
    return float(np.take_along_axis(s, expert_index, axis=-1).sum())


def greedy_balanced_objective(s: np.ndarray, top_k: int) -> float:
    """Cheap feasible lower bound: tokens in order, greedy under hard capacity."""
    s = as_numpy(s)
    n, m = s.shape
    cap = int(np.ceil(top_k * n / m))
    load = np.zeros(m, dtype=np.int64)
    total = 0.0
    for i in range(n):
        order = np.argsort(-s[i])
        picked = 0
        for j in order:
            if load[j] < cap:
                load[j] += 1
                total += s[i, j]
                picked += 1
                if picked == top_k:
                    break
    return total
