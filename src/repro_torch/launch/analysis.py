"""Roofline terms from a rank's counted program (no device needed).

Counterpart of ``repro/launch/hlo_analysis.py``:

  compute     = flops / peak                [launch/op_cost.OpCost]
  memory      = bytes / hbm_bw              [launch/op_cost.OpCost]
  collective  = collective bytes / link_bw  [ProcessMesh.stats, counted
                                             by the mesh itself]

All three are per device: the dry-run counts one rank's program.
Collective volume counts each op's result bytes once per op (the
reference's approximation; ring factors (P-1)/P are ~1 at P=256).

The reference's ``collective_bytes`` parses compiled HLO text for the
collectives GSPMD inserted. The port has no HLO and needs no parse: its
collectives are explicit calls on the mesh, which counts their calls and
bytes as they run (``launch.op_cost.collective_bytes`` maps those counts
to the reference's names).

The constants are the card's own, not the TPU's (the reference's
``hlo_analysis.py:22-24``), and fields of :class:`Roofline` with these
defaults, so the same constants can be handed to both packages.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3, 700 W (NVIDIA's data sheet, SXM part)
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s a card
HBM_BW = 3.35e12             # HBM3 bytes/s a card
LINK_BW = 450e9              # NVLink bytes/s a card, each way


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective bytes
    n_devices: int
    model_flops: float = 0.0     # 6*N*D-style useful flops (fleet-wide)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak sustained if the dominant term were the wall:
        useful_flops / (chips * peak * t_dominant)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.n_devices * self.peak_flops * t)

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes, "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def count_params(shape_tree) -> int:
    from repro_torch.core.tree import leaves
    return sum(int(l.numel()) for l in leaves(shape_tree)
               if hasattr(l, "numel"))


def count_expert_params(shape_tree) -> int:
    """Routed-expert weights only. Expert leaves are raw (E, a, b) tensors
    named .../ffn/{wi,wg,wo}; DENSE mlp weights live one level deeper
    (.../ffn/wi/w) and must NOT be counted even when period-stacking makes
    them 3-D."""
    from repro_torch.core.tree import flatten_with_path
    from repro_torch.launch.sharding import leaf_name
    total = 0
    for path, leaf in flatten_with_path(shape_tree):
        name = leaf_name(path)
        if ("ffn" in name and not name.endswith("/w")
                and getattr(leaf, "ndim", 0) >= 3 and "shared" not in name):
            total += int(leaf.numel())
    return total


def model_flops_estimate(cfg, shape, n_params: int, n_expert_params: int,
                         kind: str) -> float:
    """6*N_active*D for train, 2*N_active*D for inference-prefill,
    2*N_active*B per decoded token."""
    active = n_params - n_expert_params
    if cfg.n_experts:
        active += n_expert_params * (cfg.top_k + cfg.n_shared_experts) / cfg.n_experts
    # embedding rows aren't multiplied per token; subtract one embed table
    active -= cfg.vocab_size * cfg.d_model
    tokens = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens
