"""Device milliseconds per step of the kernels that no layer span covers: the
traced kernels' time less the kernels under the layer spans that partition
the model's step ('model/embed', 'model/attention', 'model/mamba',
'model/ffn', 'model/head', 'model/loss'), their backward twins
'bwd/<span>', and AdamW's 'train/apply'; floored at 0. Copies and sets are
left out on both sides: the trace ties only launch calls to spans
(bench/tracing.py), so a copy under 'train/apply' would read as unspanned.
None where the trace holds none of the partition's spans."""

PARTITION = ("model/embed", "model/attention", "model/mamba", "model/ffn", "model/head", "model/loss")
SPANS = PARTITION + tuple("bwd/" + k for k in PARTITION) + ("train/apply",)


def read(rec):
    if not any(k in rec["span_s"] for k in PARTITION):
        return None
    spanned = sum(rec["span_s"].get(k, 0.0) for k in SPANS)
    return 1e3 * max(sum(s for _, s in rec["kernels"]) - spanned, 0.0) / rec["steps"]
