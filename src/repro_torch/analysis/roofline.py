"""Three-term roofline of one program step on an H100 cluster (port of
`repro.analysis.roofline`).

  compute term    = per-device FLOPs / peak FLOP/s
  memory term     = per-device bytes accessed / HBM bandwidth
  collective term = per-device collective wire bytes / link bandwidth

The counts come from the dry-run (`repro_torch.launch.dryrun`), which runs
the port's program on fake tensors, and its collectives on a fake process
group; there is no compiled HLO to parse, so the JAX package's regex parse
of the post-SPMD text has no twin here.  What it kept is the ring
accounting per op kind (:func:`ring_wire_bytes`, the formulas of JAX's
parse), applied to the collectives DTensor issues.

Hardware constants (H100 SXM5 80GB, NVIDIA's *H100 Tensor Core GPU*
datasheet): 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32,
3.35 TB/s HBM3.  Links (NVIDIA's *DGX H100* datasheet): NVLink 4 at 450
GB/s each way per GPU among the 8 GPUs of a node; between nodes one 400
Gb/s NDR InfiniBand port per GPU, 50 GB/s.  A collective whose group lies
in one node of 8 (the mesh's axes laid out minor-most, as
:func:`group_link` reads them) is timed at NVLink's rate, a larger one at
the network's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Sequence, Tuple

PEAK_FLOPS = 989e12  # dense bf16 per GPU (H100 SXM datasheet)
PEAK_FLOPS_FP32 = 67e12  # fp32 per GPU, no tensor cores (H100 SXM datasheet)
HBM_BW = 3.35e12  # bytes/s per GPU (H100 SXM datasheet)
NVLINK_BW = 450e9  # bytes/s each way per GPU within a node (NVLink 4, DGX H100 datasheet)
NETWORK_BW = 50e9  # bytes/s per GPU between nodes (one 400 Gb/s NDR port, DGX H100 datasheet)
GPUS_PER_NODE = 8
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def ring_wire_bytes(op: str, nbytes: float, n: int) -> float:
    """Per-device wire bytes of one collective over a group of ``n`` ranks
    whose per-device result is ``nbytes`` (the all-gather's gathered
    buffer, the reduce-scatter's scattered shard), by ring accounting: the
    formulas of the JAX package's ``parse_collectives``."""
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}")
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    if op == "all-gather":
        return (n - 1) / n * nbytes
    if op == "reduce-scatter":
        return (n - 1) * nbytes
    if op == "all-to-all":
        return (n - 1) / n * nbytes
    return float(nbytes)  # collective-permute


def group_link(mesh_shape: Sequence[int], axes: Iterable[int],
               gpus_per_node: int = GPUS_PER_NODE) -> str:
    """"nvlink" where every group over mesh dims ``axes`` lies in one node
    of ``gpus_per_node`` GPUs, else "network".  Ranks are laid out
    row-major over ``mesh_shape`` (the last axis minor-most)."""
    axes = sorted(set(axes))
    strides = [math.prod(mesh_shape[i + 1:]) for i in range(len(mesh_shape))]
    offsets = [0]
    for a in axes:
        offsets = [o + j * strides[a] for o in offsets for j in range(mesh_shape[a])]
    others = [i for i in range(len(mesh_shape)) if i not in axes]
    bases = [0]
    for a in others:
        bases = [b + j * strides[a] for b in bases for j in range(mesh_shape[a])]
    for b in bases:
        if len({(b + o) // gpus_per_node for o in offsets}) > 1:
            return "network"
    return "nvlink"


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0  # per device
    by_op: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    by_link: Dict[str, float] = field(default_factory=dict)  # wire bytes per link kind
    time_s: float = 0.0  # each collective's wire bytes over its link's rate

    def add(self, op: str, nbytes: float, n: int, link: str = "nvlink", times: int = 1) -> None:
        """``times`` collectives ``op`` of ``nbytes`` result bytes each over
        groups of ``n`` on ``link``; a group of one moves nothing and is
        not counted."""
        if n <= 1 or times <= 0:
            return
        wire = times * ring_wire_bytes(op, nbytes, n)
        self.wire_bytes += wire
        self.by_op[op] = self.by_op.get(op, 0.0) + wire
        self.counts[op] = self.counts.get(op, 0) + times
        self.by_link[link] = self.by_link.get(link, 0.0) + wire
        self.time_s += wire / LINK_BW[link]

    def link(self) -> Tuple[str, float]:
        """(the link kind these collectives took, "nvlink", "network" or
        "mixed"; the rate that times their wire bytes in ``time_s``)."""
        kinds = [k for k, v in self.by_link.items() if v > 0]
        if len(kinds) == 1:
            return kinds[0], LINK_BW[kinds[0]]
        if not kinds:
            return "nvlink", NVLINK_BW
        return "mixed", self.wire_bytes / self.time_s


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float  # 6*N*D (or 6*N_active*D), global per step
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0
    collective_by_op: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    memory_stats: Dict[str, float] = field(default_factory=dict)
    link: str = "nvlink"  # the link kind the collective term is timed at
    link_bw: float = NVLINK_BW  # its rate, bytes/s per device

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_flops_per_device / PEAK_FLOPS
        self.memory_s = self.hlo_bytes_per_device / HBM_BW
        self.collective_s = self.collective_bytes_per_device / self.link_bw
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.dominant = max(terms, key=terms.get)
        total_hlo = self.hlo_flops_per_device * self.n_devices
        self.useful_ratio = self.model_flops / total_hlo if total_hlo else 0.0
        return self

    def step_time_bound_s(self) -> float:
        """Roofline lower bound on step time (no overlap assumption: max)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Achievable-MFU proxy: useful FLOPs at peak vs roofline-bound time."""
        ideal_s = self.model_flops / (self.n_devices * PEAK_FLOPS)
        bound = self.step_time_bound_s()
        return ideal_s / bound if bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction(),
            "step_bound_s": self.step_time_bound_s(),
            "collective_by_op": self.collective_by_op,
            "collective_counts": self.collective_counts,
            "memory_stats": self.memory_stats,
            "link": self.link,
            "link_bw": self.link_bw,
        }


def model_flops_per_step(total_params: int, active_params: int, tokens: int, kind: str) -> float:
    """6ND for training (fwd+bwd), 2ND for inference (fwd only)."""
    n = active_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
