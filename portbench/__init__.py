"""The benchmark of dxrexperiments_torch on one H100 (see harness.py)."""
