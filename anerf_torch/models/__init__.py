"""Model layer: NeRF MLP, raycaster, factory."""
