"""granite-4.0-h-small at a size a CPU test holds, added through files only:
the whole period of ten layers at width 64 with 16 experts, 2 held, top-4
(data/tiny-granite.json), 2 x 32 tokens a step (data/traffic/tiny-granite.json)
and limits of its own (data/limits/tiny-granite.json). Its plain reference
is the cell's own, bench/reference/granite_moe_hybrid.py."""
import copy
from pathlib import Path

from bench import harness

DATA = Path(__file__).resolve().parent / "data"
SPEC = {
    "configs": [{"name": "tiny-granite", "file": "bench/tests/data/tiny-granite.json"}],
    "workloads": [{"name": "tiny-granite", "config": "tiny-granite", "traffic": "tiny-granite", "chips": 1}],
    "end_to_end": [{"name": n, "unit": u} for n, u in (
        ("train_tokens_per_s", "tokens/s"), ("step_ms_p90", "ms"), ("peak_mem_gib", "GiB"), ("setup_s", "s"))],
    "per_layer": [{"name": n, "unit": u, "moves": "train_tokens_per_s"}
                  for n, u in (("avg_maxvio", "ratio"), ("mamba_ms_per_step", "ms"), ("ssd_ms_per_step", "ms"))],
}


def cell(**config_changes) -> harness.Cell:
    c = harness.resolve("tiny-granite", SPEC, base=DATA)
    if config_changes:
        c = copy.deepcopy(c)
        c.config["config"].update(config_changes)
        c.config["reduced"] = c.config["reduced"] + list(config_changes)
    return c
