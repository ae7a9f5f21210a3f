"""zamba2-2.7b — Mamba2 backbone + shared attention block (hybrid).

54 SSD layers; one *shared* full-attention transformer block applied
every 6 layers with per-invocation LoRA deltas [arXiv:2411.15242].
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    shared_attn_every=6, lora_rank=128,
    act="silu", gated_mlp=True,
    tp_pad=16,
)
