"""Unified model configuration for the assigned architecture pool."""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default: d_model // n_heads
    act: str = "silu"              # silu (SwiGLU) | geglu | gelu (ungated)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # attention flavor -------------------------------------------------------
    attn_kind: str = "gqa"         # gqa | mla | none (attention-free)
    window: int | None = None      # sliding-window size for local attention

    # MLA (DeepSeek-V2) --------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE ----------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0         # leading dense layers (DeepSeek-V2 layer 0)
    capacity_factor: float = 1.25

    # SSM (Mamba-2 SSD) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (RecurrentGemma / Griffin) -------------------------------------------
    pattern: tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "local_attn")
    lru_width: int | None = None

    # encoder-decoder (Whisper) -----------------------------------------------------
    enc_layers: int = 0
    enc_seq: int = 0               # fixed encoder context for decode cells

    # modality stubs ------------------------------------------------------------------
    frontend: str = "none"         # none | audio_stub | vlm_stub
    img_tokens: int = 0            # VLM: patch positions prepended to text

    # serving ----------------------------------------------------------------------
    decode_tail: int = 128         # two-tier KV cache: replicated append buffer

    # numerics / training ------------------------------------------------------------
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) embed scaling
    dtype: str = "bfloat16"        # activation compute dtype
    param_dtype: str = "float32"   # on-device parameter dtype (bf16 when offload)
    remat: str = "full"            # full | none | dots
    logit_softcap: float = 0.0     # gemma-style soft capping (0 = off)

    # -- derived -----------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lru(self) -> int:
        return self.lru_width if self.lru_width is not None else self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_gated_mlp(self) -> bool:
        return self.act in ("silu", "geglu")

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind for the decoder stack."""
        if self.family == "ssm":
            return ["ssm"] * self.n_layers
        if self.pattern:
            p = list(self.pattern)
            return [p[i % len(p)] for i in range(self.n_layers)]
        if self.n_experts > 0:
            return (["attn"] * self.first_k_dense
                    + ["moe"] * (self.n_layers - self.first_k_dense))
        if self.is_encdec:
            return ["xattn"] * self.n_layers  # decoder: self-attn + cross-attn
        return ["attn"] * self.n_layers

    def groups(self) -> list[tuple[int, tuple[str, ...]]]:
        """Collapse layer kinds into scan groups: (repeats, pattern).

        Homogeneous stacks become one big scan; the hybrid 1:2 pattern scans
        over pattern repetitions; a non-multiple tail becomes its own group.
        """
        kinds = self.layer_kinds()
        if self.pattern:
            p = tuple(self.pattern)
            reps, tail = divmod(self.n_layers, len(p))
            out: list[tuple[int, tuple[str, ...]]] = []
            if reps:
                out.append((reps, p))
            if tail:
                out.append((1, p[:tail]))
            return out
        out = []
        i = 0
        while i < len(kinds):
            j = i
            while j < len(kinds) and kinds[j] == kinds[i]:
                j += 1
            out.append((j - i, (kinds[i],)))
            i = j
        return out

    # -- parameter counting (for roofline MODEL_FLOPS) ------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; ``active_only`` counts MoE activated."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D
        enc = 0
        if self.is_encdec:
            per_enc = 4 * D * self.n_heads * self.hd + (3 if self.is_gated_mlp else 2) * D * F
            enc = self.enc_layers * per_enc
        per_layer = []
        for kind in self.layer_kinds():
            p = 0
            if kind in ("attn", "moe", "local_attn", "xattn"):
                if self.attn_kind == "mla":
                    p += D * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                        self.nope_head_dim + self.rope_head_dim)
                    p += D * (self.kv_lora_rank + self.rope_head_dim)
                    p += self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim)
                    p += self.n_heads * self.v_head_dim * D
                else:
                    p += D * self.n_heads * self.hd + 2 * D * self.n_kv_heads * self.hd
                    p += self.n_heads * self.hd * D
                if kind == "xattn":  # cross attention second block
                    p += 2 * (D * self.n_heads * self.hd) + 2 * (D * self.n_kv_heads * self.hd)
            if kind in ("attn", "local_attn", "xattn"):
                p += (3 if self.is_gated_mlp else 2) * D * F
            if kind == "moe":
                n_mats = 3 if self.is_gated_mlp else 2
                routed = self.n_experts * n_mats * D * self.d_ff_expert
                shared = self.n_shared_experts * n_mats * D * self.d_ff_expert
                if active_only:
                    routed = self.top_k * n_mats * D * self.d_ff_expert
                p += routed + shared + D * self.n_experts
            if kind == "ssm":
                zxbcdt = 2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads
                p += D * zxbcdt
                p += self.ssm_conv * (self.d_inner + 2 * self.ssm_groups * self.ssm_state)
                p += 3 * self.ssm_heads + self.d_inner  # A_log, D, dt_bias, gated-norm
                p += self.d_inner * D
            if kind == "rglru":
                W = self.lru
                p += 2 * D * W + self.ssm_conv * W + 3 * W * W // 1  # in-projs + conv + gates(approx)
                p += W * D
            per_layer.append(p)
        return total + enc + sum(per_layer)
