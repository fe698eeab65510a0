"""Device milliseconds per step of the kernels launched under the MoE
dispatch spans 'moe/dispatch' and 'moe/combine' (models/moe.py), forward
only (the backward runs outside every span)."""


def read(rec):
    s = sum(rec["span_s"].get(k, 0.0) for k in ("moe/dispatch", "moe/combine"))
    return 1e3 * s / rec["steps"] if s else None
