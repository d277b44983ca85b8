"""PyTorch + CUDA port of the ``repro`` MSF engines, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``comm/``, ``kernels/``, ``data/``) and its contracts:
the unique ``(w, eid)``-order MSF edge set, the capacity/overflow
contract and the ``ExchangeStats`` counters, bit for bit on the same
inputs.

What differs from the reference:

* the mesh becomes a leading shard axis in one process — per-shard
  arrays are stacked ``[p, ...]`` tensors, an all-to-all is a transpose
  of ``[p_src, p_dst, C]`` send buffers and a ``psum`` a sum over dim 0;
* each Pallas TPU kernel is a hand-written CUDA kernel for ``sm_90a``
  (``kernels/*/csrc``), built with ``nvcc`` at first use, with its plain
  PyTorch version beside it for CPU tensors;
* entry points run on ``cuda`` unless the caller passes
  ``device="cpu"`` (``device.resolve_device``), and never fall back.

This package imports neither ``jax`` nor ``repro``.
"""
