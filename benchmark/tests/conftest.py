"""The benchmark's CPU tests: run with
``python -m pytest benchmark/tests -q -p no:cacheprovider``."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
