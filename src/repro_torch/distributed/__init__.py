"""Pipeline parallelism over a mesh axis (PyTorch port of
``repro.distributed``)."""
