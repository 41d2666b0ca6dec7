"""Model configuration: a copy of repro.configs.base.ModelConfig (the port
imports nothing of the JAX package). One frozen dataclass covers every
family the reference knows, and the port serves every one: the dense
attention-only decoders (with q/k/v bias and gelu MLPs too), MoE, the
hybrid Mamba + attention stacks, the attention-free xLSTM stacks
(``layer_pattern`` of ATTN, MAMBA, MLSTM and SLSTM), the encoder-decoder
(``is_encoder_decoder``) and the VLM backbone (``num_image_tokens``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer kinds used by hybrid interleaves.
ATTN = "attn"          # full (or sliding-window) self-attention block
MAMBA = "mamba"        # selective-SSM block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    source: str                      # citation: arXiv id / hf model card
    family: str                      # dense | moe | hybrid | ssm | vlm | audio

    # Transformer backbone.
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    attn_bias: bool = False          # qwen-style qkv bias
    activation: str = "silu"         # silu (SwiGLU) | gelu (plain MLP)

    # Sliding-window attention (0 = full attention).
    swa_window: int = 0

    # MoE (num_experts = 0 -> dense MLP).
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_every: int = 1               # MoE MLP on layers where i % moe_every == moe_offset
    moe_offset: int = 0

    # Hybrid interleave: layer i kind = layer_pattern[i % len(layer_pattern)].
    # None -> all-ATTN.
    layer_pattern: Optional[Tuple[str, ...]] = None

    # SSM (mamba) block params.
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model / 16)

    # xLSTM
    xlstm_qk_dim_factor: float = 0.5

    # Encoder-decoder (whisper): encoder stack mirrors decoder dims.
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500      # whisper-base 30s -> 1500 frames (stubbed)

    # VLM: number of stub patch-embedding positions prepended to the prompt.
    num_image_tokens: int = 0

    dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_kind(self, i: int) -> str:
        if self.layer_pattern is None:
            return ATTN
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and i % self.moe_every == self.moe_offset

    @property
    def attn_layer_ids(self):
        return [i for i in range(self.num_layers) if self.layer_kind(i) == ATTN]

    # Parameter counts (for cost model + roofline MODEL_FLOPS).
    def params_per_layer(self, i: int) -> int:
        d, f, hd = self.d_model, self.d_ff, self.head_dim_
        kind = self.layer_kind(i)
        n = 0
        if kind == ATTN:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            n += q + kv + o
        elif kind == MAMBA:
            d_in = self.ssm_expand * d
            dt_rank = self.ssm_dt_rank or -(-d // 16)
            n += d * 2 * d_in                      # in_proj
            n += d_in * self.ssm_d_conv            # conv
            n += d_in * (dt_rank + 2 * self.ssm_d_state)  # x_proj
            n += dt_rank * d_in                    # dt_proj
            n += d_in * self.ssm_d_state           # A_log
            n += d_in                              # D
            n += d_in * d                          # out_proj
        elif kind in (MLSTM, SLSTM):
            d_in = self.ssm_expand * d if kind == MLSTM else d
            qk = int(d_in * self.xlstm_qk_dim_factor)
            n += d * d_in * 2 if kind == MLSTM else 0
            n += d_in * (2 * qk + d_in)            # q,k,v projections
            n += 3 * d_in                          # gates (i,f,o) per-unit
            n += d_in * d                          # out proj
        # MLP / MoE
        if kind == ATTN or (self.layer_pattern is not None and kind == MAMBA):
            mlp = 3 * d * f if self.activation == "silu" else 2 * d * f
            if self.is_moe_layer(i):
                n += self.num_experts * mlp + d * self.num_experts
            elif f > 0:
                n += mlp
        return n

    def active_params_per_layer(self, i: int) -> int:
        """Params touched per token (MoE counts top_k experts only)."""
        n = self.params_per_layer(i)
        if self.is_moe_layer(i):
            d, f = self.d_model, self.d_ff
            mlp = 3 * d * f if self.activation == "silu" else 2 * d * f
            n -= (self.num_experts - self.top_k) * mlp
        return n

    @property
    def total_params(self) -> int:
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        n += sum(self.params_per_layer(i) for i in range(self.num_layers))
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder already counted above,
            # add decoder cross-attn.
            d, f, hd = self.d_model, self.d_ff, self.head_dim_
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
            mlp = 2 * d * f  # gelu
            n += self.num_encoder_layers * (attn + mlp)
            n += self.num_layers * attn            # cross attention
        return n

    @property
    def active_params(self) -> int:
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        n += sum(self.active_params_per_layer(i) for i in range(self.num_layers))
        return n

    def kv_cache_bytes_per_token_layer(self, i: int, bytes_per_el: int = 2) -> int:
        """Per-token, per-layer recurrent/cache footprint in bytes."""
        kind = self.layer_kind(i)
        if kind == ATTN:
            eff_kv = self.num_kv_heads
            return 2 * eff_kv * self.head_dim_ * bytes_per_el
        # SSM-ish layers carry O(1) state, amortized per token -> 0 growth.
        return 0

    def reduced(self) -> "ModelConfig":
        """2-layer, d_model<=512, <=4-expert variant of the same family for smoke tests."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        # keep the GQA/MQA character: preserve ratio when possible
        if self.num_kv_heads == 1:
            kv = 1
        elif self.num_kv_heads < self.num_heads:
            kv = max(1, heads // 2)
        else:
            kv = heads
        pattern = self.layer_pattern
        nl = 2 if pattern is None else max(2, len(pattern))
        if pattern is not None and len(pattern) > 4:
            # shrink hybrid pattern but keep at least one of each kind
            kinds = []
            for k in pattern:
                if k not in kinds:
                    kinds.append(k)
            pattern = tuple(kinds * 2)[:4]
            nl = len(pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=nl,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=0,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            layer_pattern=pattern,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else self.encoder_seq_len,
            num_image_tokens=8 if self.num_image_tokens else 0,
            swa_window=min(self.swa_window, 64) if self.swa_window else 0,
            dtype="float32",
        )
