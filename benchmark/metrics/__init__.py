"""Per-layer metric readers, one file each, found by name (core.py)."""
