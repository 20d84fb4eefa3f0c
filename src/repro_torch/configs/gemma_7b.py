"""gemma-7b [dense] -- GeGLU, head_dim=256.  [arXiv:2403.08295; hf]

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000; tied embeddings,
sqrt(d_model) embedding scaling.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab=256000,
        act="geglu",
        tie_embeddings=True,
        scale_embeddings=True,
        norm_eps=1e-6,
    )
