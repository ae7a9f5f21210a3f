"""Architecture configuration — one frozen dataclass drives every family.

The ten assigned architectures (plus smoke-test reductions) are expressed
as instances of :class:`ArchConfig`; family-specific switches select the
attention variant (GQA / MQA / MLA / sliding-window mix), the FFN variant
(gated-SiLU / squared-ReLU / MoE) and the backbone (transformer / SSD /
hybrid / encoder-decoder).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: int = 0                   # 0 -> d_model // n_heads
    act: str = "silu"                 # mlp activation
    gated_mlp: bool = True            # SwiGLU-style vs plain 2-layer
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # attention pattern
    sliding_window: int = 0           # 0 = full attention
    local_global_ratio: int = 0       # gemma3: N local per 1 global
    mrope: bool = False               # qwen2-vl M-RoPE (3 sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    moe_dispatch: str = "sort"        # "sort" (O(T·k·d) scatter/gather)
    #                                 # or "onehot" (the O(T·E·cap·d)
    #                                 # einsums, the reference's baseline)

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0
    mtp: bool = False                 # multi-token-prediction head
    moe_layer_start: int = 0          # dense layers before MoE begins

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (zamba2): shared attention block every k layers
    shared_attn_every: int = 0
    lora_rank: int = 0

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_audio_frames: int = 1500

    # vlm (qwen2-vl)
    n_vision_tokens: int = 0

    dtype: str = "bfloat16"
    remat: bool = True                # activation checkpoint per layer
    use_pallas: bool = False          # kernels impl ("auto" when True)
    fsdp: bool = False                # shard params over the data axis too
    fused_attn_vjp: bool = True       # FlashAttention-2 custom backward
    attn_block_k: int = 512           # KV streaming block size
    fused_ce_loss: bool = True        # chunked LM-head+CE custom VJP
    ce_chunk: int = 512               # sequence positions per CE chunk
    seq_parallel: bool = False        # sequence-shard the residual
    #                                 # stream over `model` (§Perf)
    tp_pad: int = 1                   # pad Q heads to a multiple of this
    #   (Megatron-style: 24 heads on a 16-way model axis -> 32 padded
    #   heads, zero-masked so the math is exactly the 24-head model;
    #   fractional-head GSPMD sharding otherwise costs per-block
    #   all-reduces or full attention replication — see DESIGN.md)

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_heads(self) -> int:
        """Q heads padded up to a tp_pad multiple (zero-masked)."""
        if not self.n_heads:
            return 0
        return -(-self.n_heads // self.tp_pad) * self.tp_pad

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode cell?  SSM/hybrid have
        O(1) state; gemma3's 5:1 local layers are windowed and its sparse
        global layers shard KV by sequence."""
        return self.family in ("ssm", "hybrid") or \
            self.local_global_ratio > 0

    @property
    def kernel_impl(self) -> str:
        return "auto" if self.use_pallas else "ref"

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        emb = V * d
        head = 0 if self.tie_embeddings else d * V
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            if self.mla:
                attn = (d * self.q_lora_rank
                        + self.q_lora_rank * self.n_heads
                        * (self.d_nope + self.d_rope)
                        + d * (self.kv_lora_rank + self.d_rope)
                        + self.kv_lora_rank * self.n_heads
                        * (self.d_nope + self.d_v)
                        + self.n_heads * self.d_v * d)
            else:
                hd = self.head_dim
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            if self.n_experts:
                fe = self.moe_d_ff or f
                mult = 3 if self.gated_mlp else 2
                ffn = self.n_experts * mult * d * fe \
                    + self.n_shared_experts * mult * d * fe + d * self.n_experts
            else:
                ffn = (3 if self.gated_mlp else 2) * d * f
            per_layer = attn + ffn + 2 * d
        elif self.family in ("ssm", "hybrid"):
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * N + H)
            per_layer = in_proj + di * d + self.ssm_conv * (di + 2 * N) \
                + 2 * d + 2 * H + di
            if self.family == "hybrid" and self.shared_attn_every:
                hd = self.head_dim
                shared = (d * self.n_heads * hd
                          + 2 * d * self.n_kv_heads * hd
                          + self.n_heads * hd * d
                          + 3 * d * self.d_ff + 2 * d)
                n_uses = self.n_layers // self.shared_attn_every
                lora = n_uses * self.lora_rank * 2 * d * 4
                return emb + head + per_layer * self.n_layers + shared + lora
        total = emb + head + per_layer * self.n_layers
        if self.enc_dec:
            hd = self.head_dim
            enc_layer = (2 * (d * self.n_heads * hd
                              + 2 * d * self.n_kv_heads * hd
                              + self.n_heads * hd * d) // 2
                         + 2 * d * f + 3 * d)
            total += self.n_enc_layers * enc_layer
        return total

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test reduction: same family/topology, tiny dims."""
        base = dict(
            n_layers=min(self.n_layers, 2 if not self.shared_attn_every
                         else 2 * self.shared_attn_every),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            name=self.name + "-smoke",
            remat=False,
            fsdp=False,
        )
        if self.mla:
            base.update(q_lora_rank=64, kv_lora_rank=32, d_nope=16,
                        d_rope=16, d_v=16, d_head=0)
        elif self.d_head:
            base.update(d_head=32)
        if self.n_experts:
            base.update(n_experts=min(self.n_experts, 8),
                        top_k=min(self.top_k, 2),
                        moe_d_ff=min(self.moe_d_ff or self.d_ff, 64),
                        moe_layer_start=min(self.moe_layer_start, 1))
        if self.ssm_state:
            base.update(ssm_state=min(self.ssm_state, 16),
                        ssm_head_dim=32, ssm_chunk=16)
        if self.shared_attn_every:
            base.update(shared_attn_every=2, lora_rank=4)
        if self.enc_dec:
            base.update(n_enc_layers=2, n_audio_frames=32)
        if self.n_vision_tokens:
            base.update(n_vision_tokens=8)
        if self.mrope:
            half = (overrides.get("d_head") or 32) // 2
            base.update(mrope_sections=(half // 2, half // 4, half // 4))
        if self.local_global_ratio:
            # one full (ratio+1)-layer group so the grouped scan is
            # non-empty
            base.update(sliding_window=16, local_global_ratio=2,
                        n_layers=3)
        base.setdefault("tp_pad", 1)      # no head padding in smoke tests
        base.update(overrides)
        return replace(self, **base)
