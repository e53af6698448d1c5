"""The closed saccade serving loop (PyTorch port)."""
