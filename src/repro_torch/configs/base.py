"""Model architecture configs.

A copy of the JAX package's ``ModelConfig`` and its sub-configs, field for
field, so that one configuration means the same model in both packages
(the parity tests compare the two dataclasses field by field, full and
``.reduced()``).  One dataclass covers every family via a per-layer
``block_pattern`` and optional sub-configs (MoE, MLA, Mamba, xLSTM,
encoder-decoder, modality front-end stubs).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0       # DeepSeek-style always-on shared expert(s)
    shared_d_ff: int = 0              # d_ff of the shared expert
    dense_residual_d_ff: int = 0      # Arctic-style dense MLP in parallel w/ MoE
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25
    # layers whose index % period != offset fall back to a dense FFN
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    first_dense_layers: int = 0       # DeepSeek-V3: first k layers are dense
    first_dense_d_ff: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 SSM block configuration (Jamba interleave)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block configuration (sLSTM + mLSTM)."""

    # mLSTM: matrix memory C in R^{heads x dk x dv}; sLSTM: scalar memory.
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    conv1d_kernel_size: int = 4
    # within each group of ``slstm_every`` blocks, one is sLSTM (xLSTM[7:1])
    slstm_every: int = 8


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder (audio) architectures."""

    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    # frontend stub: precomputed frame embeddings of shape (B, frames, d_model)
    max_source_positions: int = 4096


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend carve-out: input_specs() provides precomputed
    patch/frame embeddings of this shape instead of raw pixels/waveforms."""

    kind: str                 # "vision" | "audio"
    num_prefix_tokens: int    # patches per image / frames per utterance
    embed_dim: int            # dimension of the precomputed embeddings


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

VALID_BLOCKS = ("attn", "mamba", "mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    source: str                # citation (arXiv id or model card)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // num_heads
    # per-layer block pattern; entry i gives the mixer of layer i.
    # empty -> all-attention.
    block_pattern: Tuple[str, ...] = ()
    # attention details
    attention_kind: str = "gqa"          # "gqa" | "mla"
    rope_theta: float = 10_000.0
    use_rope: bool = True
    abs_pos: str = "none"              # "none" | "sinusoidal" (added at embed)
    sliding_window: Optional[int] = None  # architecture's own native window
    # long-context decode policy: window applied only for the long_500k shape
    long_context_window: int = 8192
    # norm / activation
    rms_norm_eps: float = 1e-5
    activation: str = "swiglu"           # "swiglu" | "gelu" | "gelu_mlp"
    tie_embeddings: bool = False
    residual_scale: float = 1.0          # MiniCPM depth-scaled residuals
    logit_scale: float = 1.0             # MiniCPM mup-style logit scaling
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendStub] = None
    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0
    dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_pattern:
            object.__setattr__(
                self, "block_pattern", tuple(["attn"] * self.num_layers)
            )
        # user-supplied configuration is validated with real exceptions,
        # not asserts: it must fail loudly under ``python -O`` too
        if len(self.block_pattern) != self.num_layers:
            raise ValueError(
                f"{self.name}: block_pattern len {len(self.block_pattern)} "
                f"!= num_layers {self.num_layers}")
        for b in self.block_pattern:
            if b not in VALID_BLOCKS:
                raise ValueError(f"unknown block kind {b!r}")
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: num_heads {self.num_heads} not divisible "
                f"by num_kv_heads {self.num_kv_heads}")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    @property
    def attn_layer_ids(self) -> Tuple[int, ...]:
        return tuple(i for i, b in enumerate(self.block_pattern) if b == "attn")

    def layer_is_moe(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if i < m.first_dense_layers:
            return False
        return i % m.moe_layer_period == m.moe_layer_offset

    # -- parameter counting (used for rooflines & memory estimates) ---------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count. active_only counts only routed
        experts that fire per token (top_k of num_experts)."""
        d, l = self.d_model, self.num_layers
        n = 2 * self.vocab_size * d if not self.tie_embeddings else self.vocab_size * d
        for i, blk in enumerate(self.block_pattern):
            n += 2 * d  # norms
            if blk == "attn":
                n += self._attn_params()
            elif blk == "mamba":
                n += self._mamba_params()
            elif blk in ("mlstm", "slstm"):
                n += self._xlstm_params(blk)
            if blk in ("mlstm", "slstm"):
                continue  # xLSTM blocks have no separate FFN (d_ff == 0)
            n += self._ffn_params(i, active_only)
        if self.encoder is not None:
            e = self.encoder
            per = 4 * e.d_model * e.d_model + 3 * e.d_model * e.d_ff + 2 * e.d_model
            n += e.num_layers * per
            # cross-attention in each decoder layer
            n += l * 4 * d * d
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention_kind == "mla":
            m = self.mla
            assert m is not None
            qk = m.qk_head_dim
            n = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            n += self.num_heads * m.v_head_dim * d
            return n
        hd = self.head_dim
        return (
            d * self.num_heads * hd
            + 2 * d * self.num_kv_heads * hd
            + self.num_heads * hd * d
        )

    def _ffn_params(self, i: int, active_only: bool) -> int:
        d = self.d_model
        m = self.moe
        if m is None or not self.layer_is_moe(i):
            dff = self.d_ff
            if m is not None and i < m.first_dense_layers and m.first_dense_d_ff:
                dff = m.first_dense_d_ff
            if dff == 0:
                return 0
            mult = 3 if self.activation == "swiglu" else 2
            return mult * d * dff
        mult = 3 if self.activation == "swiglu" else 2
        n_experts = m.top_k if active_only else m.num_experts
        n = n_experts * mult * d * m.expert_d_ff + d * m.num_experts  # router
        if m.num_shared_experts:
            n += m.num_shared_experts * mult * d * (m.shared_d_ff or m.expert_d_ff)
        if m.dense_residual_d_ff:
            n += mult * d * m.dense_residual_d_ff
        return n

    def _mamba_params(self) -> int:
        mc = self.mamba or MambaConfig()
        d = self.d_model
        d_in = mc.expand * d
        dt_rank = mc.dt_rank or -(-d // 16)
        n = d * d_in * 2                     # in_proj (x and z)
        n += d_in * mc.d_conv                # conv1d
        n += d_in * (dt_rank + 2 * mc.d_state)  # x_proj
        n += dt_rank * d_in + d_in           # dt_proj
        n += d_in * mc.d_state + d_in        # A_log, D
        n += d_in * d                        # out_proj
        return n

    def _xlstm_params(self, kind: str) -> int:
        xc = self.xlstm or XLSTMConfig()
        d = self.d_model
        h = self.num_heads
        if kind == "mlstm":
            d_in = int(xc.proj_factor_mlstm * d)
            n = 2 * d * d_in                 # up-proj (x, z)
            n += 3 * d_in * d_in // h        # q,k,v headwise (block-diagonal)
            n += 3 * d_in                    # i,f,o gate projections (per-dim)
            n += d_in * mc_conv(xc)          # causal conv
            n += d_in * d                    # down proj
            return n
        d_in = int(xc.proj_factor_slstm * d)
        n = 4 * d * d // h + 4 * d * d       # recurrent (headwise) + input gates
        n += d * d_in * 2 + d_in * d         # gated FFN up/down
        return n

    # -- reduced variant for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant (<=2 layers, d_model<=512, <=4 experts)
        that runs a real forward/train step on CPU."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        head_dim = 64
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        if n_heads % n_kv:
            n_kv = 1
        n_layers = min(self.num_layers, 2)
        pattern = self._reduced_pattern(n_layers)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=128,
                shared_d_ff=128 if self.moe.num_shared_experts else 0,
                dense_residual_d_ff=128 if self.moe.dense_residual_d_ff else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                first_dense_d_ff=256 if self.moe.first_dense_d_ff else 0,
                moe_layer_period=1,
                moe_layer_offset=0,
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(
                q_lora_rank=64, kv_lora_rank=64,
                qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=64,
            )
            head_dim = 64
        encoder = None
        if self.encoder is not None:
            encoder = dataclasses.replace(
                self.encoder, num_layers=2, d_model=d_model,
                num_heads=n_heads, d_ff=256, max_source_positions=16,
            )
        frontend = None
        if self.frontend is not None:
            frontend = dataclasses.replace(
                self.frontend, num_prefix_tokens=8, embed_dim=d_model
            )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            block_pattern=pattern,
            moe=moe,
            mla=mla,
            encoder=encoder,
            frontend=frontend,
            mtp_depth=0,
            dtype="float32",
        )

    def _reduced_pattern(self, n_layers: int) -> Tuple[str, ...]:
        kinds = []
        seen = []
        for b in self.block_pattern:  # keep one of each distinct kind, in order
            if b not in seen:
                seen.append(b)
        while len(kinds) < n_layers:
            kinds.extend(seen)
        return tuple(kinds[:n_layers])


def mc_conv(xc: XLSTMConfig) -> int:
    return xc.conv1d_kernel_size


# ---------------------------------------------------------------------------
# Input shapes (the dry run's)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
