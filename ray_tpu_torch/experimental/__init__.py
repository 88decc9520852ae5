"""Experimental subsystems (reference: python/ray/experimental/). The port
has the compiled DAG's channel plane (``channel.py``); JAX's device
channel and rdt (``device_channel.py``, ``rdt.py``) wait for ROADMAP Queue
1, M10."""
