"""Per-architecture configs (assigned pool) + the paper's vision suite."""
ARCH_MODULES = [
    "zamba2_2_7b", "whisper_tiny", "granite_moe_1b_a400m",
    "deepseek_v3_671b", "mamba2_370m", "minitron_4b", "gemma3_27b",
    "nemotron_4_340b", "granite_20b", "qwen2_vl_2b",
]
