"""nemotron-4-340b — 96L GQA dense with squared-ReLU MLP
[arXiv:2402.16819].  bf16 optimizer moments + FSDP to fit the pod."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000,
    act="sqrelu", gated_mlp=False, fsdp=True,
    tp_pad=16,
)
