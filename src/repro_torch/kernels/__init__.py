"""CUDA kernels for Hopper (sm_90a) with their plain PyTorch versions.

``dirty_diff`` (``csrc/dirty_diff.cu``) and ``diff_pack``
(``csrc/pack_diff.cu``) replace the JAX package's Pallas kernels
``dirty_diff_tpu`` and ``diff_pack_tpu``.  :mod:`.ops` dispatches by the
tensors' device, :mod:`.ref` holds the plain versions, and :mod:`._build`
compiles the sources with nvcc at first use.  Importing this package builds
and loads nothing.
"""
