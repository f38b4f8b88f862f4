"""InternVL2-1B [arXiv:2404.16821] — VLM: InternViT-300M (stubbed frontend)
feeding a Qwen2-0.5B-style LM backbone (24L, d=896, 14H GQA kv=2).

The vision encoder is a stub: requests carry precomputed patch embeddings
of shape (B, num_prefix_tokens, embed_dim)
(``repro_torch.workloads.default_extras``); the projector (MLP embed_dim ->
d_model) and LM backbone are implemented.
"""
from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1_000_000.0,
    activation="swiglu",
    tie_embeddings=True,
    frontend=FrontendStub(kind="vision", num_prefix_tokens=256, embed_dim=1024),
)
