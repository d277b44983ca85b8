"""Hand-written Hopper kernels, one subpackage each.

Each ``kernels/<name>/`` holds the CUDA source (``csrc/*.cu``, built by
``_build.py`` with ``nvcc`` at first use), the wrapper that launches it
(and counts its launches), ``ref.py`` with the plain PyTorch version the
wrapper uses for CPU tensors, and ``ops.py`` with the dispatchers.
"""
