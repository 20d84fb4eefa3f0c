"""Input data: the deterministic synthetic corpus, window-backed shards and
background prefetch (the counterpart of ``repro.data``)."""

from .pipeline import SyntheticLM, WindowBackedDataset, make_batch_iter

__all__ = ["SyntheticLM", "WindowBackedDataset", "make_batch_iter"]
