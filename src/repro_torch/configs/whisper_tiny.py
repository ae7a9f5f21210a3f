"""whisper-tiny — encoder-decoder ASR backbone [arXiv:2212.04356].

The conv/log-mel frontend is a STUB per the assignment: input_specs()
provides precomputed frame embeddings (B, 1500, 384).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    enc_dec=True, n_enc_layers=4, n_audio_frames=1500,
    act="gelu", gated_mlp=False, tie_embeddings=True,
    tp_pad=16,
)
