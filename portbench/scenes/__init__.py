"""Frozen scene generators, one module per ``generator`` named in a
configuration file under ``configs/``."""
