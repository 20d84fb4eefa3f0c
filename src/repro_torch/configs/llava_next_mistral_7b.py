"""llava-next-mistral-7b [vlm] -- anyres tiling (patch frontend stubbed).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Mistral-7B backbone: 32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000.
``input_specs`` provides precomputed patch embeddings (576 base-tile tokens)
that are projected and prepended to the text sequence; loss masks patch
positions.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=32000,
        rope_theta=1000000.0,
        frontend="vlm_stub",
        img_tokens=576,
        norm_eps=1e-5,
    )
