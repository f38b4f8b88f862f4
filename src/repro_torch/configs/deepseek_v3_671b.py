"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA attention (latent KV),
1 shared + 256 routed experts top-8, first 3 layers dense, MTP head.

MLA means the serving state is the compressed latent c_kv (512) + rope key
(64) per token — ~14x smaller than full 128-head KV. This makes AcceLLM's
redundant-KV copies especially cheap: the mirror and the stream move the
latent line.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA: all heads share the latent; kept for bookkeeping
    head_dim=128,
    d_ff=2048,         # routed expert intermediate size
    vocab_size=129280,
    attention_kind="mla",
    activation="swiglu",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        expert_d_ff=2048,
        num_shared_experts=1,
        shared_d_ff=2048,
        first_dense_layers=3,
        first_dense_d_ff=18432,
    ),
    mtp_depth=1,
)
