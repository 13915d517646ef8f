"""The benchmark's own tests (CPU; they import neither JAX nor the JAX
package): `python -m pytest perfbench/tests -q` from the repository's
root."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
