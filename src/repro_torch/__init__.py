"""flexvec on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

Mirrors ``repro``'s layout module for module.  The three Pallas kernels of
the Phase-2 path (``pem_score``, ``topk``, ``mmr``) are CUDA C++ kernels
for ``sm_90a`` under ``csrc/``, built at first use; everything around them
is PyTorch and numpy.  Imports neither JAX nor ``repro``.
"""
