"""Architecture registry of the port: ``get_config("llama2-70b")``.

Holds the two dense GQA decoders this slice serves, with the published
numbers of repro/configs/llama2_70b.py and repro/configs/granite_8b.py.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

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
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)} (ROADMAP.md lists the rest)")
    return _REGISTRY[name]
