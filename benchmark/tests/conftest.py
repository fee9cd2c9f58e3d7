"""The benchmark's tests import the harness as ``benchmark.*`` from the
repository's root, and build cells at a tiny size for the CPU."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
