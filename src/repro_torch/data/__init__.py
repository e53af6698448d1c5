"""Synthetic data sources (numpy)."""
