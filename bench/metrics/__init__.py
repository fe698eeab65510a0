"""Per-layer metric readers: `<metric>.py` holds `read(rec)`, which takes
the traced run's records (bench/tracing.py, with 'steps', 'loads',
'config', 'mix' and 'tokens_per_step' added by the harness) and returns the
metric's value, or None where the trace holds nothing to read."""
