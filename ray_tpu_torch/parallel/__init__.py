"""Parallelism for the PyTorch port: the mesh, its sharding and its
collectives (``mesh``), ring attention (``ring_attention``), Ulysses
(``ulysses``), the expert-parallel MoE FFN (``moe``) and GPipe over the
pp axis (``pipeline``)."""
