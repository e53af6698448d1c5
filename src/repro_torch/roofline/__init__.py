"""Roofline cost model on the H100 (``analysis``)."""
