"""The fused BIP dual update's (K3, kernels/csrc/bip_admm.cu) share of its
roofline: the least time of each MoE layer's update in the traced steps
(bench/counts.py, 512 bins, one refining pass) over the kernel's device time."""
from bench import counts

KERNEL = "bip_dual_update_kernel"


def read(rec):
    t = sum(s for name, s in rec["kernels"] if KERNEL in name)
    if t <= 0:
        return None
    r = rec["config"]["routing"]
    per_step = len(rec["loads"][0]) * counts.k3_update_bound_s(
        rec["tokens_per_step"], r["n_experts"], r["top_k"], r["bip_iters"])
    return 100.0 * per_step * rec["steps"] / t
