"""granite-20b-code — MQA (kv=1) GPT-BigCode-style code model
[arXiv:2405.04324].  The single KV head is replicated across the model
axis (the paper's broadcast-operand case)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    act="gelu", gated_mlp=False,
    tp_pad=16,
)
