"""Device milliseconds per step of the kernels launched under the span
'mamba/ssd' (models/mamba2.py: the chunked SSD core, `ssd_chunked`, inside
'model/mamba') and its backward twin 'bwd/mamba/ssd'. The span nests inside
the Mamba layer's, so this time is also mamba_ms_per_step's."""

SPANS = ("mamba/ssd", "bwd/mamba/ssd")


def read(rec):
    s = sum(rec["span_s"].get(k, 0.0) for k in SPANS)
    return 1e3 * s / rec["steps"] if s else None
