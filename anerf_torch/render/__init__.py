"""Rendering: full-image renderer, pose generators, the render catalog
and mesh extraction."""
