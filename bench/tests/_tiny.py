"""A cell at a size a CPU test holds: minimind-moe-16e cut to 2 layers of
width 64 with 4 experts (data/tiny-moe.json), 4 x 32 tokens a step
(data/traffic/tiny.json), with limits set from 12 CPU seeds of this size
(data/limits/tiny.json)."""
import copy
from pathlib import Path

from bench import harness

DATA = Path(__file__).resolve().parent / "data"
SPEC = {
    "configs": [{"name": "tiny-moe", "file": "bench/tests/data/tiny-moe.json"}],
    "workloads": [{"name": "tiny", "config": "tiny-moe", "traffic": "tiny", "chips": 1}],
    "end_to_end": [{"name": n, "unit": u} for n, u in (
        ("train_tokens_per_s", "tokens/s"), ("step_ms_p90", "ms"), ("peak_mem_gib", "GiB"), ("setup_s", "s"))],
    "per_layer": [],
}


def cell(**config_changes) -> harness.Cell:
    c = harness.resolve("tiny", SPEC, base=DATA)
    if config_changes:
        c = copy.deepcopy(c)
        c.config["config"].update(config_changes)
        c.config["reduced"] = c.config["reduced"] + list(config_changes)
    return c
