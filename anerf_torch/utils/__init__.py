"""Utilities: config, image helpers (numpy copies of anerf_tpu.utils)."""
