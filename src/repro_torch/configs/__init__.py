"""Architecture registry of the port: ``get_config("llama2-70b")``,
``list_archs()``.

Holds the configurations the port serves, with the published numbers of
the reference's files under repro/configs/: llama2_70b.py, granite_8b.py
(dense GQA decoders), granite_20b.py (MQA, 48 query heads on one kv head,
a gelu MLP without a gate), codeqwen1_5_7b.py (MHA with q/k/v bias, RoPE
base 1e6), h2o_danube_1_8b.py (a dense GQA decoder with a 4096-token
sliding window, head dim 80: the launcher's default),
phi3_5_moe_42b_a6_6b.py (16 experts top-2 on every layer),
granite_moe_3b_a800m.py (40 experts top-8, 24 query heads on 8 kv heads of
64), jamba_v0_1_52b.py (hybrid Mamba + attention 1:7 with MoE, 16 experts
top-2, on every other layer) and xlstm_125m.py (attention-free: three
mLSTM blocks and one sLSTM block a period).
"""
from __future__ import annotations

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig

_REGISTRY = {
    cfg.name: cfg for cfg in (
        ModelConfig(name="llama2-70b", source="arXiv:2307.09288",
                    family="dense", num_layers=80, d_model=8192,
                    num_heads=64, num_kv_heads=8, d_ff=28672,
                    vocab_size=32000),
        ModelConfig(name="granite-8b", source="arXiv:2405.04324",
                    family="dense", num_layers=36, d_model=4096,
                    num_heads=32, num_kv_heads=8, d_ff=14336,
                    vocab_size=49152),
        ModelConfig(name="granite-20b", source="arXiv:2405.04324",
                    family="dense", num_layers=52, d_model=6144,
                    num_heads=48, num_kv_heads=1, d_ff=24576,
                    vocab_size=49152, activation="gelu"),
        ModelConfig(name="codeqwen1.5-7b", source="hf:Qwen/CodeQwen1.5-7B",
                    family="dense", num_layers=32, d_model=4096,
                    num_heads=32, num_kv_heads=32, d_ff=13440,
                    vocab_size=92416, attn_bias=True,
                    rope_theta=1_000_000.0),
        ModelConfig(name="h2o-danube-1.8b", source="arXiv:2401.16818",
                    family="dense", num_layers=24, d_model=2560,
                    num_heads=32, num_kv_heads=8, d_ff=6912,
                    vocab_size=32000, swa_window=4096),
        ModelConfig(name="jamba-v0.1-52b", source="arXiv:2403.19887",
                    family="hybrid", num_layers=32, d_model=4096,
                    num_heads=32, num_kv_heads=8, d_ff=14336,
                    vocab_size=65536, num_experts=16, top_k=2, moe_every=2,
                    moe_offset=1,
                    layer_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA,
                                   MAMBA, MAMBA),
                    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2),
        ModelConfig(name="phi3.5-moe-42b-a6.6b",
                    source="hf:microsoft/Phi-3.5-MoE-instruct",
                    family="moe", num_layers=32, d_model=4096,
                    num_heads=32, num_kv_heads=8, d_ff=6400,
                    vocab_size=32064, num_experts=16, top_k=2),
        ModelConfig(name="granite-moe-3b-a800m",
                    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
                    family="moe", num_layers=32, d_model=1536,
                    num_heads=24, num_kv_heads=8, d_ff=512,
                    vocab_size=49155, num_experts=40, top_k=8),
        ModelConfig(name="xlstm-125m", source="arXiv:2405.04517",
                    family="ssm", num_layers=12, d_model=768, num_heads=4,
                    num_kv_heads=4, d_ff=0, vocab_size=50304,
                    layer_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
                    ssm_expand=2, xlstm_qk_dim_factor=0.5),
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)} (ROADMAP.md lists the rest)")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)
