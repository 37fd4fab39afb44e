"""Compute primitives: rays, encodings, compositing, fused kernels.

Submodules are imported by path; importing this package builds and
loads nothing.
"""
