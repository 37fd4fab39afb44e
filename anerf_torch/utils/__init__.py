"""Utilities: config, image helpers (numpy copies of anerf_tpu.utils) and
the device resolution shared by the renderer and the trainer."""
