"""deepseek-v3-671b — MLA + 1 shared + 256 routed top-8 experts + MTP
[arXiv:2412.19437].

Assignment d_ff=2048 is the routed-expert hidden dim; the 3 dense
warm-up layers use the paper's 18432 FFN.  FSDP sharding over the data
axis is required to fit 671B on 256/512 v5e chips.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    moe_layer_start=3,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    d_nope=128, d_rope=64, d_v=128, mtp=True,
    act="silu", gated_mlp=True, fsdp=True,
    tp_pad=16,
)
