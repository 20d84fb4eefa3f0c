"""Runtime services of the training loop: gradient compression and fault
hooks (the counterparts of ``repro.runtime.compress`` and
``repro.runtime.fault``).  Collectives and sharding are later slices
(ROADMAP.md queue A, A12 and A14)."""
