"""Device milliseconds per step of the kernels launched under the layer span
'model/mamba' (models/stack.py: the pre-norm, the Mamba-2 mixer with its
projections, conv and SSD, the residual add) and its backward twin
'bwd/model/mamba'."""

SPANS = ("model/mamba", "bwd/model/mamba")


def read(rec):
    s = sum(rec["span_s"].get(k, 0.0) for k in SPANS)
    return 1e3 * s / rec["steps"] if s else None
