"""mamba2-2.7b [ssm] -- SSD (state-space duality).  [arXiv:2405.21060]

64L d_model=2560, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads; tied embeddings.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=1,            # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab=50280,
        attn_kind="none",
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_conv=4,
        tie_embeddings=True,
        norm_eps=1e-5,
    )
