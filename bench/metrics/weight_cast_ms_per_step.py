"""Device milliseconds per step of the kernels launched under the span
'model/weight_cast' (models/common.cast_weight: each weight cast to the
compute dtype at its use) and its backward twin 'bwd/model/weight_cast'
(the gradient cast back to the weight's dtype). The span nests inside the
layer spans, so this time is also theirs."""

SPANS = ("model/weight_cast", "bwd/model/weight_cast")


def read(rec):
    s = sum(rec["span_s"].get(k, 0.0) for k in SPANS)
    return 1e3 * s / rec["steps"] if s else None
