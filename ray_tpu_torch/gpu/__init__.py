"""CUDA devices as a cluster resource — the port's counterpart of
``ray_tpu/tpu``: detection and visibility (``accelerator.py``) and gang
placement on an NVLink domain (``slice.py``, for ``tpu/slice.py``);
preemption and the profiler wait for later slices (ROADMAP Queue 1)."""
