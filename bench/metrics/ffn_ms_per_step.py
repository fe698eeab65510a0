"""Device milliseconds per step of the kernels launched under the layer span
'model/ffn' (models/stack.py: the ffn norm, the MoE FFN with its router,
dispatch, K1/K2 and combine, the shared expert, the residual add) and its
backward twin 'bwd/model/ffn'."""

SPANS = ("model/ffn", "bwd/model/ffn")


def read(rec):
    s = sum(rec["span_s"].get(k, 0.0) for k in SPANS)
    return 1e3 * s / rec["steps"] if s else None
