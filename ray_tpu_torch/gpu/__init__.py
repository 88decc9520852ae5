"""CUDA devices as a cluster resource — the port's counterpart of
``ray_tpu/tpu`` (detection and visibility only; slices, preemption and the
profiler wait for later slices, ROADMAP Queue 1)."""
