"""CUDA kernels for Hopper (sm_90a) with their plain PyTorch versions.

``dirty_diff`` (``csrc/dirty_diff.cu``), ``diff_pack``
(``csrc/pack_diff.cu``), ``flash_attention`` (``csrc/flash_attention.cu``),
``ssd_scan`` (``csrc/ssd_scan.cu``) and ``rg_lru`` (``csrc/rg_lru.cu``)
replace the JAX package's Pallas kernels ``dirty_diff_tpu``,
``diff_pack_tpu``, ``flash_attention_tpu``, ``ssd_scan_tpu`` and
``rg_lru_tpu``: all five.  Attention and the SSD scan have a second
kernel each for bfloat16 inputs, on the tensor cores: ``flash_attention_tc``
(``csrc/flash_attention_tc.cu``) and ``ssd_scan_tc``
(``csrc/ssd_scan_tc.cu``).  :mod:`.ops` dispatches by the tensors' device
and, for those two, by dtype;
:mod:`.ref` holds the plain versions, and :mod:`._build` compiles the
sources with nvcc at first use.  Importing this package builds and loads nothing.
"""
