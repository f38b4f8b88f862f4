"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense, MHA (kv=36), WSD
schedule (the JAX package's repro.training.schedules), mup-style depth-scaled
residuals and logit scaling."""
import math

from repro_torch.configs.base import ModelConfig

_NUM_LAYERS = 40

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    num_layers=_NUM_LAYERS,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    activation="swiglu",
    tie_embeddings=True,
    # MiniCPM: residual branch scaled by 1.4/sqrt(num_layers); logits by
    # 1/(d_model / 256) (mup base width 256).
    residual_scale=1.4 / math.sqrt(_NUM_LAYERS),
    logit_scale=256.0 / 2304.0,
)
