"""Sequence parallelism for the PyTorch port: the mesh (``mesh``), ring
attention (``ring_attention``) and Ulysses (``ulysses``)."""
