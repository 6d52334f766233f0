"""repro_torch — the PyTorch/CUDA port of the XFA reproduction.

A second package beside the JAX reference (`repro`).  It imports `torch`
and never `jax` or anything of `repro`: the jax-free reference modules it
needs (configs, the XFA host layer, the profile store, the scheduler)
live here as its own copies.  Module names mirror the reference so each
counterpart is easy to find.

Every entry point runs on `cuda` unless the caller passes
`device="cpu"`; without CUDA it raises instead of falling back.  The
Pallas TPU kernels of the serving path are CUDA C++ kernels for Hopper
(`kernels/csrc/`), built with nvcc at first use.
"""
