"""Architecture configuration schema.

Every assigned architecture is a declarative ``ArchConfig``; the model
registry (``models/registry.py``) builds parameter specs and step functions
from it.  ``smoke()`` derives the reduced same-family config used by the
per-arch CPU smoke tests.  A copy of the JAX package's schema: the port
builds the dense decoders from it (``models/registry.py``) and reads the
rest as data until their slices land.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["MoEConfig", "SSMConfig", "XLSTMConfig", "ArchConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    # apply MoE every `period` layers with offset `offset` (jamba: 2/1);
    # period 1 means every layer is MoE.
    period: int = 1
    offset: int = 0
    # capacity factor for expert token bins (the paper's technique applied
    # to expert capacity; tokens beyond capacity are dropped GShard-style).
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2

    def is_moe_layer(self, idx: int) -> bool:
        return (idx % self.period) == self.offset if self.period > 1 else True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM (used by jamba)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)

    def inner(self, d_model: int) -> int:
        return self.expand * d_model

    def rank(self, d_model: int) -> int:
        return self.dt_rank or int(math.ceil(d_model / 16))


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack options (mLSTM parallel + sLSTM recurrent)."""

    # up-projection factor inside the mLSTM block
    m_proj_factor: float = 2.0
    # gated-FFN projection factor inside the sLSTM block
    s_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # norm / activation
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_np
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # mixture of experts
    moe: Optional[MoEConfig] = None

    # heterogeneous layer pattern, one char per layer within a period:
    #   'A' attention block, 'M' Mamba block, 'l' mLSTM block, 's' sLSTM block
    # None means all-'A'.  len(layer_pattern) must divide n_layers; the layer
    # stack is stacked over periods with the pattern unrolled inside.
    layer_pattern: Optional[str] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # encoder-decoder (seamless): n_layers applies to the decoder
    encdec: bool = False
    n_encoder_layers: int = 0

    # modality frontend stub: number of positions filled by precomputed
    # frame/patch embeddings supplied via input_specs()
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_tokens: int = 0

    # serving
    sliding_window: int = 0  # 0 = full attention

    # source provenance tag from the assignment table
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def pattern(self) -> str:
        if self.layer_pattern is None:
            return "A"
        return self.layer_pattern

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def attention_free(self) -> bool:
        return "A" not in self.pattern

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: recurrent/hybrid archs, not pure attention."""
        p = self.pattern
        return any(c in p for c in "Msl")

    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"layer_pattern length {len(self.pattern)} must divide "
                f"n_layers {self.n_layers}"
            )
        if "M" in self.pattern and self.ssm is None:
            raise ValueError("pattern contains Mamba blocks but ssm config is None")
        if any(c in self.pattern for c in "ls") and self.xlstm is None:
            raise ValueError("pattern contains xLSTM blocks but xlstm config is None")

    # ---- reduced config for CPU smoke tests ---------------------------------
    def smoke(self) -> "ArchConfig":
        """Same-family reduced config: tiny dims, same structural features."""
        pat = self.pattern
        n_layers = max(2 * len(pat) // math.gcd(2 * len(pat), len(pat)), len(pat))
        # keep exactly two periods of the pattern
        n_layers = 2 * len(pat)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=64,
            )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 // max(1, self.q_per_kv)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_encoder_layers=2 if self.encdec else 0,
            frontend_tokens=8 if self.frontend else 0,
            moe=moe,
        )

    # ---- parameter count (for roofline MODEL_FLOPS) -------------------------
    def param_counts(self) -> Tuple[int, int]:
        """Returns (total_params, active_params) analytically."""
        d, hd = self.d_model, self.head_dim_
        q_dim = self.n_heads * hd
        kv_dim = self.n_kv_heads * hd

        def attn_params() -> int:
            n = d * (q_dim + 2 * kv_dim) + q_dim * d
            if self.qkv_bias:
                n += q_dim + 2 * kv_dim
            if self.qk_norm:
                n += 2 * hd
            return n

        def dense_ffn() -> int:
            if self.d_ff == 0:
                return 0
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * self.d_ff

        def moe_ffn(cfg: MoEConfig) -> Tuple[int, int]:
            mult = 3 if self.act == "swiglu" else 2
            per_expert = mult * d * cfg.expert_d_ff
            router = d * cfg.num_experts
            total = cfg.num_experts * per_expert + router
            active = cfg.top_k * per_expert + router
            return total, active

        def mamba_params() -> int:
            assert self.ssm is not None
            di = self.ssm.inner(d)
            r = self.ssm.rank(d)
            n = d * 2 * di  # in_proj
            n += di * self.ssm.d_conv + di  # conv + bias
            n += di * (r + 2 * self.ssm.d_state)  # x -> dt, B, C
            n += r * di + di  # dt_proj
            n += di * self.ssm.d_state + di  # A_log, D
            n += di * d  # out_proj
            return n

        def mlstm_params() -> int:
            assert self.xlstm is not None
            du = int(self.xlstm.m_proj_factor * d)
            n = d * 2 * du  # up (path, gate)
            n += du * self.xlstm.conv_kernel + du
            n += 3 * du * du + 3 * du  # q,k,v (+ igate/fgate/ogate proj)
            n += du * d
            return n

        def slstm_params() -> int:
            n = 4 * d * d + 4 * d  # i,f,z,o projections
            du = int(self.xlstm.s_proj_factor * d) if self.xlstm else d
            n += 2 * d * du + du * d  # gated FFN
            return n

        total = active = 0
        for i in range(self.n_layers):
            c = self.pattern[i % len(self.pattern)]
            if c == "A":
                total += attn_params()
                active += attn_params()
            elif c == "M":
                total += mamba_params()
                active += mamba_params()
            elif c == "l":
                total += mlstm_params()
                active += mlstm_params()
            elif c == "s":
                total += slstm_params()
                active += slstm_params()
            # FFN (attention/mamba blocks carry the FFN; xLSTM blocks don't)
            if c in ("A", "M") and (self.d_ff or self.moe):
                if self.moe is not None and self.moe.is_moe_layer(i):
                    ttl, act = moe_ffn(self.moe)
                    total += ttl
                    active += act
                elif self.d_ff:
                    total += dense_ffn()
                    active += dense_ffn()

        if self.encdec:
            # encoder self-attn + FFN, decoder cross-attn already in n_layers?
            # decoder layers get an extra cross-attention block:
            total += self.n_layers * attn_params()
            active += self.n_layers * attn_params()
            for _ in range(self.n_encoder_layers):
                total += attn_params() + dense_ffn()
                active += attn_params() + dense_ffn()

        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        return total, active
