"""Llama-2-70B [arXiv:2307.09288] — the paper's own evaluation model
(AcceLLM §5.2). Used by the simulator and as an 11th selectable config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-70b",
    family="dense",
    source="arXiv:2307.09288",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    activation="swiglu",
)
