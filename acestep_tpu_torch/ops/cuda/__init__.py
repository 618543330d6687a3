"""Hand-written CUDA kernels (csrc/*.cu) and their wrappers.

Importing these modules builds nothing: the library is compiled by ``nvcc`` and
loaded at the first launch (``_build.lib()``).
"""
