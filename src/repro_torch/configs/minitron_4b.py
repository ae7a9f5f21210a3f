"""minitron-4b — width/depth-pruned Nemotron-4 [arXiv:2407.14679].
Squared-ReLU non-gated MLP per the Nemotron lineage."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab=256000,
    act="sqrelu", gated_mlp=False,
    tp_pad=16,
)
