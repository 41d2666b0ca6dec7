"""Roofline terms of a counted step on one NVIDIA H100 SXM (the port of
repro.launch.roofline, whose ceilings are a TPU v5e's).

  compute term    = sum over dtypes of FLOPs / peak of that dtype
  memory term     = bytes / HBM bandwidth
  collective term = collective bytes / NVLink bandwidth

each of one card's share of the step (all of it on one card; card 0's on
a mesh, ``launch.dryrun --mesh``).

The peaks are NVIDIA's published dense rates of one H100 SXM at its full
700 W power limit (``CARD``, ``POWER_LIMIT_W``): 989 TFLOP/s in bf16 and
fp16, 1979 in fp8 and int8, 67 TFLOP/s in float32 outside the tensor cores
(the port turns TF32 off, so float32 products and every elementwise op
run there) and 3.35 TB/s of HBM. A card set below 700 W runs below them.
The compute term takes each FLOP at the peak of the dtype that does it
(``launch.op_analysis.OpCounter.work``).

The collective term divides the card's per-partition collective result
bytes (``launch.op_analysis.OpCounter.coll_bytes``: each row-parallel
reduction, gather and vocabulary-split lookup of its shard, as the
reference sums an HLO module's) by one H100 SXM's NVLink bandwidth,
``NVLINK_BW``: 900 GB/s, NVLink 4 (18 links), from NVIDIA's H100 Tensor
Core GPU datasheet. It treats every collective as one transfer of its
result at that rate, as the reference's term does with its 50 GB/s ICI
link. A step counted on one card has no collectives: 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

CARD = "NVIDIA H100 SXM"
POWER_LIMIT_W = 700.0
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12,
              "int8": 1979e12, "fp32": 67e12}
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 900e9            # bytes/s / card, NVLink 4 (H100 SXM datasheet)
HBM_BYTES = 80 * 2 ** 30     # the port's card memory (80 GiB)


@dataclasses.dataclass
class Roofline:
    flops: float                  # per card
    hbm_bytes: float              # per card
    coll_bytes: Dict[str, int]    # per card, by kind (none on one card)
    model_flops: float            # 6 N D (analytic, global)
    chips: int
    work: Dict[str, float]        # FLOPs by the dtype that does them
    xla_raw: Optional[dict] = None   # the reference's field; no XLA here

    @property
    def compute_s(self) -> float:
        return sum(f / PEAK_FLOPS[dt] for dt, f in self.work.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes.values()) / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        if self.flops <= 0:
            return None
        return self.model_flops / (self.flops * self.chips)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": dict(self.coll_bytes),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "chips": self.chips,
            "work": dict(self.work),
            "card": CARD,
            "power_limit_w": POWER_LIMIT_W,
            "xla_raw": self.xla_raw,
        }


def extract(counter, *, model_flops: float, chips: int = 1) -> Roofline:
    """The roofline of a step (one card's share of it) counted by
    ``op_analysis.OpCounter``; `chips` the cards that share it."""
    return Roofline(flops=counter.flops, hbm_bytes=counter.bytes,
                    coll_bytes=dict(counter.coll_bytes),
                    model_flops=model_flops, chips=chips,
                    work=dict(counter.work))


def model_flops_estimate(cfg, shape) -> float:
    """6·N_active·D for train (fwd+bwd), 2·N_active·D for inference."""
    n_active = cfg.active_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # one decode token
