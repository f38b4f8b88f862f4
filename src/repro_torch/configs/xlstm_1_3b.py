"""xLSTM-1.3B [arXiv:2405.04517] — attention-free SSM-style stack of mLSTM
(matrix memory) and sLSTM (scalar memory) blocks, ratio 7:1 (xLSTM[7:1]).
d_ff=0: blocks carry their own up/down projections, no separate FFN."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

_N = 48
_XC = XLSTMConfig(slstm_every=8)
# xLSTM[7:1]: within each group of 8 blocks, one sLSTM (placed mid-group).
_PATTERN = tuple(
    "slstm" if i % _XC.slstm_every == _XC.slstm_every // 2 else "mlstm"
    for i in range(_N)
)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=_N,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,  # mLSTM head dim = d_inner / heads (set at block level)
    d_ff=0,
    vocab_size=50304,
    use_rope=False,
    block_pattern=_PATTERN,
    xlstm=_XC,
    tie_embeddings=True,
)
