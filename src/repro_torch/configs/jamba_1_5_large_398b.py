"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention with a
1:7 attn:mamba interleave and 16-expert top-2 MoE on every other layer.

72 layers = 9 Jamba blocks of 8 layers; the attention layer sits at offset 4
of each block (as in the Jamba paper).  MoE FFN on odd layers, dense FFN
(d_ff=24576) on even layers.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

_N = 72
_PATTERN = tuple("attn" if i % 8 == 4 else "mamba" for i in range(_N))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=_N,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    use_rope=False,  # Jamba uses no positional embeddings (mamba provides order)
    block_pattern=_PATTERN,
    activation="swiglu",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        expert_d_ff=24576,
        moe_layer_period=2,
        moe_layer_offset=1,
    ),
)
