"""Hand-written CUDA kernels for Hopper and their plain-torch versions.

Each kernel: a wrapper module here (checks, ctypes launch, launch count),
its CUDA source in ``csrc/``, and its plain version in ``ref.py``.
``build.py`` compiles the sources with ``nvcc`` at first use.
"""
