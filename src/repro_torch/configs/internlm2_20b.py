"""internlm2-20b [dense] -- GQA.  [arXiv:2403.17297; hf]

48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92544.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=92544,
        rope_theta=1000000.0,
        norm_eps=1e-5,
    )
