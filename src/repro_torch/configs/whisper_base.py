"""whisper-base [audio] -- encoder-decoder, conv frontend stubbed.
[arXiv:2212.04356]

6L encoder + 6L decoder, d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
``input_specs`` provides precomputed frame embeddings (the mel+conv
frontend is a stub, as in the reference).  Positional encoding is sinusoidal
on both stacks (a deviation, as in the reference: real Whisper learns
its decoder positions).  Decode cells run the decoder with a fixed
1500-frame encoder context.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        act="gelu",
        enc_layers=6,
        enc_seq=1500,
        frontend="audio_stub",
        norm_eps=1e-5,
    )
