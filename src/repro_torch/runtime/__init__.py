"""Runtime services of the training loop: gradient compression and fault
hooks (the counterparts of ``repro.runtime.compress`` and
``repro.runtime.fault``).  Collectives and sharding are a later slice
(ROADMAP.md queue A14)."""
