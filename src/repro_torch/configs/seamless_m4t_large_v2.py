"""SeamlessM4T-large-v2 [arXiv:2308.11596] — encoder-decoder, multimodal
(speech/text). Backbone only: 24L text decoder (d=1024, 16H, d_ff=8192,
GeLU MLP) with cross-attention over a 24L encoder.

The speech frontend (mel-spectrogram + w2v-BERT conv feature extractor) is a
stub: requests carry precomputed frame embeddings (B, frames, 1024)
(``repro_torch.workloads.default_extras``) consumed directly by the encoder
stack.
"""
from repro_torch.configs.base import EncoderConfig, FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    use_rope=False,  # learned/sinusoidal positions in the original; we use
                     # absolute sinusoidal embeddings for the backbone.
    abs_pos="sinusoidal",
    activation="gelu_mlp",
    encoder=EncoderConfig(
        num_layers=24, d_model=1024, num_heads=16, d_ff=8192,
        max_source_positions=4096,
    ),
    frontend=FrontendStub(kind="audio", num_prefix_tokens=4096, embed_dim=1024),
)
