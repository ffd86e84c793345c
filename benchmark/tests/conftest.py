"""The benchmark's own tests: the checkout's root on the import path, so
that ``benchmark`` and the program import as they do in a run."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
