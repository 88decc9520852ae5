"""CUDA devices as a cluster resource — the port's counterpart of
``ray_tpu/tpu``: detection and visibility (``accelerator.py``), gang
placement on an NVLink domain (``slice.py``, for ``tpu/slice.py``), the GCE
preemption watcher (``preemption.py``) and ``torch.profiler`` capture
(``profiler.py``)."""
