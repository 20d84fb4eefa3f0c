"""llama4-maverick-400b-a17b [moe] -- 128 experts, top-1 routing.
[hf:meta-llama/Llama-4; listed config]

48L d_model=5120 40H (GQA kv=8) vocab=202048.  Maverick interleaves MoE
with dense layers 1:1 (hf ``interleave_moe_layer_step=2``): 24 MoE layers
(128 routed experts d_ff=8192, top-1, + 1 shared expert) and 24 dense
layers (d_ff_mlp=16384) -- the interleaving is what makes the 400B total /
17B active arithmetic work.  Text backbone only ("early fusion" frontend
is out of scope per the assignment's modality-stub rule).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,            # dense (non-MoE) layers
        vocab=202048,
        pattern=("attn", "moe"),  # 1:1 interleave, scanned as 24 x 2
        n_experts=128,
        n_shared_experts=1,
        top_k=1,
        d_ff_expert=8192,
        rope_theta=500000.0,
        param_dtype="bfloat16",  # optimizer state offloaded to storage windows
        norm_eps=1e-5,
    )
