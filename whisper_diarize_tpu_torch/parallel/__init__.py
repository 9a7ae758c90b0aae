"""Chunk batching of the PyTorch port (the JAX package's device meshes are
not ported yet)."""
