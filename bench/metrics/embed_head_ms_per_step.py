"""Device milliseconds per step of the kernels launched under the layer spans
'model/embed' (the token gather), 'model/head' (final norm, unembedding) and
'model/loss' (log-softmax, cross entropy, the aux loss added), each with its
backward twin 'bwd/<span>' (models/model.py)."""

SPANS = ("model/embed", "model/head", "model/loss",
         "bwd/model/embed", "bwd/model/head", "bwd/model/loss")


def read(rec):
    s = sum(rec["span_s"].get(k, 0.0) for k in SPANS)
    return 1e3 * s / rec["steps"] if s else None
