"""Heterogeneous device pool descriptors: GPU/TPU catalog, machines, regions,
and the alpha-beta communication matrices (paper §4.1: A = latency, B =
bandwidth).

The paper's evaluation environments are reproduced verbatim:
  - homogeneous:        2 x p4d.24xlarge (8 x A100-40G each), $65.54/h
  - hetero full-price:  58 GPUs across Iceland/Norway/Nevada/Illinois, $65.04/h
  - hetero half-price:  30 GPUs across Iceland/Norway/Nevada, $29.6/h
  - case study (§3.1):  4xA6000 + 2xA5000 + 2xA4000

Network constants follow the paper's footnote 3: intra-region 2 ms / 5 Gbps,
inter-region 40-150 ms / 0.3-1.0 Gbps; intra-machine NVLink (A100) or PCIe.

A TPU v5e entry is included so the same scheduler can plan over mixed pod
slices (the TPU-native analogue of a heterogeneous pool — see DESIGN.md §3).

The port's copy of repro.core.cluster (it imports nothing of the JAX
package), row for row: the catalog has no H100 entry, as the reference's
has none.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

GB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    mem_bytes: float          # M_d
    mem_bw: float             # m_d, bytes/s
    flops: float              # c_d, FLOP/s (fp16/bf16 tensor)
    price_per_hour: float
    intra_machine_bw: float   # bytes/s between peers on the same machine
    intra_machine_lat: float  # seconds


GPU_CATALOG: Dict[str, GPUSpec] = {
    # name                mem          mem_bw      flops      $/h    intra bw    lat
    "A100-40G": GPUSpec("A100-40G", 40 * GB, 1555e9, 312e12, 4.10, 600e9 / 2, 5e-6),
    "3090Ti":   GPUSpec("3090Ti",   24 * GB, 1008e9, 160e12, 1.10, 25e9,      1e-5),
    "A6000":    GPUSpec("A6000",    48 * GB,  768e9, 155e12, 1.35, 25e9,      1e-5),
    "A5000":    GPUSpec("A5000",    24 * GB,  768e9, 111e12, 1.00, 25e9,      1e-5),
    "A4000":    GPUSpec("A4000",    16 * GB,  448e9,  76e12, 0.60, 25e9,      1e-5),
    "A40":      GPUSpec("A40",      48 * GB,  696e9, 150e12, 1.30, 25e9,      1e-5),
    # TPU target (per-chip; ICI links, DESIGN.md §3)
    "TPUv5e":   GPUSpec("TPUv5e",   16 * GB,  819e9, 197e12, 1.20, 50e9,      1e-6),
}

INTRA_REGION_LAT, INTRA_REGION_BW = 2e-3, 5e9 / 8          # 2 ms, 5 Gbps
INTER_REGION_LAT, INTER_REGION_BW = 100e-3, 0.6e9 / 8      # mid-range of 40-150ms / .3-1Gbps


@dataclasses.dataclass(frozen=True)
class Device:
    id: int
    type: str                 # key into GPU_CATALOG
    machine: int
    region: str

    @property
    def spec(self) -> GPUSpec:
        return GPU_CATALOG[self.type]


class Cluster:
    """Device pool + comm matrices. A[i,j] latency (s), B[i,j] bandwidth (B/s)."""

    def __init__(self, devices: Sequence[Device],
                 lat: Optional[np.ndarray] = None,
                 bw: Optional[np.ndarray] = None):
        self.devices: List[Device] = list(devices)
        n = len(self.devices)
        if lat is None or bw is None:
            lat = np.zeros((n, n))
            bw = np.full((n, n), np.inf)
            for a, b in itertools.combinations(range(n), 2):
                da, db = self.devices[a], self.devices[b]
                if da.machine == db.machine:
                    l = max(da.spec.intra_machine_lat, db.spec.intra_machine_lat)
                    w = min(da.spec.intra_machine_bw, db.spec.intra_machine_bw)
                elif da.region == db.region:
                    l, w = INTRA_REGION_LAT, INTRA_REGION_BW
                else:
                    l, w = INTER_REGION_LAT, INTER_REGION_BW
                lat[a, b] = lat[b, a] = l
                bw[a, b] = bw[b, a] = w
        self.lat = lat
        self.bw = bw

    def __len__(self):
        return len(self.devices)

    @property
    def price_per_hour(self) -> float:
        return sum(d.spec.price_per_hour for d in self.devices)

    def machines(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for d in self.devices:
            out.setdefault(d.machine, []).append(d.id)
        return out

    def subset(self, ids: Sequence[int]) -> List[Device]:
        return [self.devices[i] for i in ids]


def _build(machines: List[Tuple[str, int, str]]) -> Cluster:
    """machines: list of (gpu_type, count, region)."""
    devices = []
    for m, (gtype, count, region) in enumerate(machines):
        for _ in range(count):
            devices.append(Device(len(devices), gtype, m, region))
    return Cluster(devices)


def homogeneous_a100() -> Cluster:
    """2 x AWS p4d.24xlarge."""
    return _build([("A100-40G", 8, "us-east"), ("A100-40G", 8, "us-east")])


def hetero_full_price() -> Cluster:
    """Paper §5.1: 58 GPUs, ~$65/h."""
    return _build([
        ("3090Ti", 8, "iceland"), ("3090Ti", 8, "iceland"),
        ("3090Ti", 3, "norway"), ("3090Ti", 3, "norway"),
        ("A5000", 8, "nevada"),
        ("A6000", 8, "illinois"), ("A6000", 8, "illinois"),
        ("A5000", 8, "illinois"),
        ("A40", 4, "illinois"),
    ])


def hetero_half_price() -> Cluster:
    """Paper §5.1: 30 GPUs, ~$29.6/h."""
    return _build([
        ("3090Ti", 8, "iceland"), ("3090Ti", 8, "iceland"),
        ("3090Ti", 3, "norway"), ("3090Ti", 3, "norway"),
        ("A5000", 8, "nevada"),
    ])


def case_study_cluster() -> Cluster:
    """Paper §3.1 case study: 4xA6000 + 2xA5000 + 2xA4000 (one region)."""
    return _build([
        ("A6000", 4, "region0"), ("A5000", 2, "region0"),
        ("A4000", 2, "region0"),
    ])


def tpu_mixed_slices() -> Cluster:
    """Beyond-paper: two v5e slices of different sizes joined over DCN."""
    return _build([("TPUv5e", 8, "zone-a"), ("TPUv5e", 4, "zone-a"),
                   ("TPUv5e", 4, "zone-b")])
