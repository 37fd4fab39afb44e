"""Data: the numpy data store, datasets, loaders and the input pipeline."""
