"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the routing wrappers (``ops``)."""
