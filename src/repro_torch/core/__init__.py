"""Analog frontend physics and the compact frontend (PyTorch port)."""
