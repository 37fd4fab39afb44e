"""Training and rendering over several processes (``sharding``)."""
