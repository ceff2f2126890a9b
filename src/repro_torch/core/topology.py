"""Supernode topology model + roofline hardware constants of the port.

The port of ``repro.core.topology``.  The reference models a TPU pod; the
port's card is one NVIDIA H100 SXM 80GB (HBM3) at its full 700 W power
limit (``nvidia-smi --query-gpu=name,power.limit``: "NVIDIA H100 80GB
HBM3, 700.00 W"), and every rate below is that card's, from NVIDIA's data
sheet (dense rates; :mod:`repro_torch.kernels.perf_model` holds the same
two).  A card set below 700 W runs slower under load than these say.  The
framework sees one logical device matrix, a rank a card; the logical mesh
shapes (a 256-device matrix, two of them over ``pod``) stay the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.kernels.perf_model import (H100_HBM_BYTES_PER_S,
                                            H100_PEAK_FLOPS)

# -- roofline constants (per card): H100 SXM 80GB, 700 W -----------------------
PEAK_FLOPS_BF16 = H100_PEAK_FLOPS["bfloat16"]   # 989e12 FLOP/s, dense
HBM_BW = H100_HBM_BYTES_PER_S                   # 3.35e12 B/s
# one NVLink 4 link, one direction: 900 GB/s over 18 links, both directions
ICI_BW_PER_LINK = 25e9                          # B/s per link
HBM_BYTES = 80 * 10 ** 9                        # 80 GB of HBM3
# host <-> card (HyperOffload's legs): PCIe Gen5 x16, one direction
HOST_BW = 64e9                                  # B/s


@dataclasses.dataclass(frozen=True)
class SupernodeSpec:
    """Describes one supernode (paper §2.3: Matrix384-like abstraction)."""
    name: str
    chips: int
    pods: int
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW_PER_LINK
    hbm_bytes: int = HBM_BYTES

    @property
    def total_flops(self) -> float:
        return self.peak_flops * self.chips

    def axis_size(self, name: str) -> int:
        return self.mesh_shape[self.axis_names.index(name)]


SINGLE_POD = SupernodeSpec("h100-256", 256, 1, (16, 16), ("data", "model"))
MULTI_POD = SupernodeSpec("h100-2pod-512", 512, 2, (2, 16, 16),
                          ("pod", "data", "model"))


def spec_for(multi_pod: bool) -> SupernodeSpec:
    return MULTI_POD if multi_pod else SINGLE_POD


# -- roofline terms ------------------------------------------------------------
def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_collective_bytes: float,
                   spec: SupernodeSpec = SINGLE_POD) -> Dict[str, float]:
    """The three per-step time lower bounds, in seconds.

    Inputs are PER-DEVICE quantities, so no further division by the card
    count.
    """
    compute = per_device_flops / spec.peak_flops
    memory = per_device_bytes / spec.hbm_bw
    collective = per_device_collective_bytes / spec.ici_bw
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant,
            "bound_s": max(compute, memory, collective)}


def model_flops(cfg, tokens: int, *, training: bool) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params."""
    n = cfg.active_param_count()
    mult = 6.0 if training else 2.0
    return mult * n * tokens
