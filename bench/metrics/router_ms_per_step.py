"""Device milliseconds per step of the kernels launched under the router's
spans 'router/*' (core/router.py, core/balancers.py and K3 through
kernels/ops.bip_dual_update), forward only: the backward runs on
autograd's thread, outside every span."""


def read(rec):
    s = sum(v for k, v in rec["span_s"].items() if k.startswith("router/"))
    return 1e3 * s / rec["steps"] if s else None
