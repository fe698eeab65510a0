"""The benchmark's own tests (run as `python -m pytest bench/tests` from the
repository's root): the harness and the port's sources on the path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
