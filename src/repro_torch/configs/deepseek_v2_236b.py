"""deepseek-v2-236b [moe] -- MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

60L d_model=5120 128H, MoE d_ff_expert=1536, vocab=102400.  Layer 0 is a
dense MLP (d_ff=12288, hf-faithful); MLA: q_lora 1536, kv_lora 512,
rope/nope/v head dims 64/128/128.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,        # MLA: latent-compressed, kv head count = H
        d_ff=12288,            # dense first layer (hf config)
        vocab=102400,
        attn_kind="mla",
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1536,
        first_k_dense=1,
        rope_theta=10000.0,
        param_dtype="bfloat16",  # optimizer state offloaded to storage windows
        norm_eps=1e-6,
    )
