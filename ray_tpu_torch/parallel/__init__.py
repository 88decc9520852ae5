"""Parallelism for the PyTorch port: the mesh, its sharding and its
collectives (``mesh``), ring attention (``ring_attention``), Ulysses
(``ulysses``) and the expert-parallel MoE FFN (``moe``)."""
