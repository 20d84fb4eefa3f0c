"""CUDA kernels for Hopper (sm_90a) with their plain PyTorch versions.

``dirty_diff`` (``csrc/dirty_diff.cu``), ``diff_pack``
(``csrc/pack_diff.cu``), attention, the SSD scan and ``rg_lru_pipe``
(``csrc/rg_lru_pipe.cu``) replace the JAX package's Pallas kernels
``dirty_diff_tpu``, ``diff_pack_tpu``, ``flash_attention_tpu``,
``ssd_scan_tpu`` and ``rg_lru_tpu``: all five.  Attention and the SSD scan
have two kernels each on the tensor cores, one per dtype: bfloat16
``flash_attention_tc`` and ``ssd_scan_tc`` (``csrc/*_tc.cu``), float32
``flash_attention_tc32`` and ``ssd_scan_tc32`` (``csrc/*_tc32.cu``);
``rg_lru_pipe`` takes both dtypes.  The earlier kernels, ``flash_attention``
(``csrc/flash_attention.cu``) and ``ssd_scan`` (``csrc/ssd_scan.cu``) on
the CUDA cores and ``rg_lru`` (``csrc/rg_lru.cu``), are on no path and stay
as comparators.  :mod:`.ops` dispatches by the tensors' device and, for
attention, the scan and the recurrence, by dtype; :mod:`.ref` holds the
plain versions, and :mod:`._build` compiles the sources with nvcc at first
use.  Importing this package builds and loads nothing.
"""
