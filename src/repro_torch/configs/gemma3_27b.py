"""gemma3-27b — 5:1 local:global attention, 1024-token sliding window,
128k+ context [hf:google/gemma-3-*].  head_dim pinned at 128."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144, d_head=128,
    local_global_ratio=5, sliding_window=1024,
    act="gelu", gated_mlp=True, tie_embeddings=True,
    tp_pad=16,
)
