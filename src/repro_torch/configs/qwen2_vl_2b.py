"""qwen2-vl-2b — M-RoPE decoder backbone [arXiv:2409.12191].

The ViT frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings merged into the token stream; M-RoPE uses
sections (16, 24, 24) over head_dim/2 = 64.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    mrope=True, mrope_sections=(16, 24, 24), n_vision_tokens=256,
    act="silu", gated_mlp=True, tie_embeddings=True,
    tp_pad=16,
)
