"""Experimental subsystems (reference: python/ray/experimental/): the
compiled DAG's channel plane (``channel.py``), the device object plane
(``rdt.py``) and the device channel over a collective group
(``device_channel.py``), each the port's copy of the JAX package's."""
