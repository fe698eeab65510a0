"""Device milliseconds per step of the kernels launched under the
optimizer's span 'train/apply' (optim/adamw.py)."""


def read(rec):
    s = rec["span_s"].get("train/apply")
    return 1e3 * s / rec["steps"] if s else None
