"""Device milliseconds per step of the kernels launched under the layer span
'model/attention' (models/stack.py: pre-norm, attention, optional post-norm,
residual add) and its backward twin 'bwd/model/attention'."""

SPANS = ("model/attention", "bwd/model/attention")


def read(rec):
    s = sum(rec["span_s"].get(k, 0.0) for k in SPANS)
    return 1e3 * s / rec["steps"] if s else None
