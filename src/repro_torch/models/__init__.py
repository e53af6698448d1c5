"""The ViT backend of the saccade loop (PyTorch port)."""
