"""whisper-large-v3 [audio]: encoder-decoder, conv frontend stubbed
(precomputed 1500-frame embeddings).  32L(+32 enc) d_model=1280 20H (MHA)
d_ff=5120 vocab=51866.  [arXiv:2212.04356; unverified]

Whisper uses absolute positions (sinusoidal enc / learned dec) and full MHA
(kv=20 == heads); no RoPE.  The "32L" of the assignment is the decoder; the
real model pairs it with a 32-layer encoder, included here (override
`n_encoder_layers` to shrink)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    act="gelu",
    pos_embedding="learned",
    tie_embeddings=True,
    frontend="audio_stub",
    encoder_seq=1500,
    max_target_positions=448,
)
