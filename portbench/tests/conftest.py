"""Tests of the benchmark itself, on the CPU (``-m cuda``: on the card).

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
