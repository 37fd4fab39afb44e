"""Rendering: full-image renderer and pose generators."""
