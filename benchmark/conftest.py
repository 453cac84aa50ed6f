"""The benchmark's tests import its ``harness`` and the port beside it;
ranks that a test starts inherit this path."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (HERE, HERE.parent):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
