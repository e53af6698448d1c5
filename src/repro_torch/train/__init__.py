"""The fault-tolerant training loop and the classifier's step (``trainer``)."""
