"""StarCoder2-3B [arXiv:2402.19173] — dense, GQA kv=2, RoPE, native sliding
window 4096."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999_999.0,
    sliding_window=4096,
    activation="gelu",  # starcoder2 uses gelu MLP (c_fc/c_proj)
)
