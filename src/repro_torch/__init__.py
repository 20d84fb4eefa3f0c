"""repro_torch -- MPI windows on storage, in PyTorch, for an NVIDIA H100.

The second package of this repository, beside the JAX package ``repro``
(the reference).  It is ported in slices; this one holds the storage-window
stack and the device side of selective sync:

    core       windows, the user-level page cache, the inproc transport,
               out-of-core arrays (its own copy of ``repro.core``)
    kernels    the ``dirty_diff`` and ``diff_pack`` CUDA kernels for
               sm_90a, their plain PyTorch versions, and the nvcc build
    train      ``OutOfCoreAdamW`` with ``sync_masters_from_device``
    models     ``ModelConfig`` and the dense ``param_specs``
    configs    internlm2-1.8b
    convert    numpy <-> torch trees (bf16 through a same-width int view)

It imports ``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.
Entry points that allocate tensors take ``device=`` and default to
``"cuda"``; the kernels follow the device of the tensors they are given.
"""
