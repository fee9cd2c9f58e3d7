"""One reader a per-layer metric, found by its file name (harness/registry.py)."""
