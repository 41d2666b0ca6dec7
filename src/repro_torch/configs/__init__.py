"""Architecture registry of the port: ``get_config("llama2-70b")``.

Holds the configurations the port serves, with the published numbers of
repro/configs/llama2_70b.py, repro/configs/granite_8b.py (dense GQA
decoders), repro/configs/h2o_danube_1_8b.py (a dense GQA decoder with a
4096-token sliding window, head dim 80: the launcher's default) and
repro/configs/jamba_v0_1_52b.py (hybrid Mamba + attention 1:7 with MoE, 16
experts top-2, on every other layer).
"""
from __future__ import annotations

from repro_torch.configs.base import ATTN, MAMBA, ModelConfig

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
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)} (ROADMAP.md lists the rest)")
    return _REGISTRY[name]
