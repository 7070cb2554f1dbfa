"""Data: generation, ``.npz`` I/O, split and batching, normalization."""
