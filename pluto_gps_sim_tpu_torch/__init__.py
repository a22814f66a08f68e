"""pluto_gps_sim_tpu_torch — the GPS L1 C/A IQ synthesizer on PyTorch + CUDA.

A port of ``pluto_gps_sim_tpu`` (JAX + Pallas on a TPU) to PyTorch with
a hand-written CUDA kernel for NVIDIA Hopper.  The layout mirrors the
JAX package module for module:

  * the f64 host control plane (ingest, models, ``ops/epoch``, scenario,
    allocator, scheduler) is numpy, copied from the JAX package with
    only its jax ties removed;
  * ``ops/synth_torch`` packs superframe plans for the kernel;
  * ``ops/synth_cuda`` holds the parameter-plane builder, the CUDA
    synthesis kernel's wrapper and its plain PyTorch twin;
  * ``runtime/stream`` pipelines host planning, the kernel and the
    device-to-host copy; ``cli`` drives it into a sink.

This package never imports jax.
"""

__version__ = "0.1.0"
