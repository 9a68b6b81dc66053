"""Test set-up of the benchmark's own tests: the checkout's root (for the
``perfbench`` package) and ``src`` (for the program) on the path.  Run
them from the checkout's root with ``python -m pytest -q perfbench/tests``;
every test runs on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
