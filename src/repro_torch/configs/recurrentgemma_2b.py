"""recurrentgemma-2b [hybrid] -- RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427; hf]

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000;
pattern (rglru, rglru, local_attn) with window 2048; lru_width=2560.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        act="geglu",
        pattern=("rglru", "rglru", "local_attn"),
        window=2048,
        lru_width=2560,
        tie_embeddings=True,
        scale_embeddings=True,
        norm_eps=1e-6,
    )
