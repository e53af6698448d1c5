"""Meshes, partition-spec fitting and placements, and the input stand-ins
(PyTorch port of ``repro.launch``)."""
