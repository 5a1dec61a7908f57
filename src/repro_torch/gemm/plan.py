"""``GemmPlan``: the frozen, hashable description of one GEMM dispatch --
everything decided above the inner loop, resolved once per shape and
reused on every call: geometry, backend, the block triple, the pack
decision, the lever that produced it, the epilogue, the fused split map,
the decode lane's split-K slice count and the weight's pack-time format
(fp32, or a quantized format run by the dequant-fused kernels).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.kernels.panel_gemm import EpilogueSpec  # noqa: F401

LEVER_FINE_PANELS = "fine_panels"   # K >= N: occupancy-sized column panels
LEVER_PREPACK = "prepack"           # N > K: deep-K pre-packed weight

# Pack decisions (how execute() treats a RAW weight; a PackedWeight has
# already paid its pack at load):
PACK_PREPACKED = "prepacked"   # weight should be packed once at load
PACK_PERCALL = "percall"       # transpose+pad inside the call (baseline)
PACK_NONE = "none"             # no re-layout at all (raw-product analogue)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Shape-resolved GEMM dispatch decision.

    ``epilogue`` is the store step's :class:`EpilogueSpec` (None = plain
    GEMM); ``fused_n_splits`` the split map of a ``pack_fused`` weight;
    ``decode`` marks a plan of the decode arm and ``split_k`` its K slice
    count, resolved per (n, k) at the canonical decode M so that every
    decode batch width shares one slice map.  ``weight_format`` is
    ``"fp32"`` or the quantized format of the pack the plan executes."""
    m: int
    n: int
    k: int
    dtype: str
    backend: str
    block_m: int
    block_n: int
    block_k: int
    pack: str
    lever: str
    t_pred: float = float("nan")
    occupancy: float = float("nan")
    transposed: bool = False
    validated: bool = False
    epilogue: EpilogueSpec | None = None
    fused_n_splits: tuple = ()
    vmem_clamped: bool = False
    weight_format: str = "fp32"
    split_k: int = 1
    decode: bool = False

    @property
    def prepack(self) -> bool:
        return self.pack == PACK_PREPACKED

    @property
    def m_pad(self) -> int:
        return math.ceil(self.m / self.block_m) * self.block_m

    @property
    def n_pad(self) -> int:
        return math.ceil(self.n / self.block_n) * self.block_n

    @property
    def k_pad(self) -> int:
        return math.ceil(self.k / self.block_k) * self.block_k

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.m_pad // self.block_m, self.n_pad // self.block_n,
                self.k_pad // self.block_k)

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.m, self.n, self.k)

    @property
    def glu(self) -> bool:
        return self.epilogue is not None and self.epilogue.glu is not None

    @property
    def quantized(self) -> bool:
        """True when this plan executes a quantized pack-time format."""
        return self.weight_format != "fp32"

    @property
    def n_out(self) -> int:
        """Output columns execute() returns: one part for glu, else N."""
        if self.glu:
            return (self.fused_n_splits[0] if self.fused_n_splits
                    else self.n // 2)
        return self.n

    def describe(self) -> str:
        epi = ""
        if self.epilogue is not None:
            epi = f", epilogue={self.epilogue}"
        if self.fused_n_splits:
            epi += f", fused={self.fused_n_splits}"
        if self.quantized:
            epi += f", weight_format={self.weight_format}"
        if self.decode:
            epi += f", lane=decode, split_k={self.split_k}"
        elif self.split_k != 1:
            epi += f", split_k={self.split_k}"
        if self.vmem_clamped:
            epi += ", vmem_clamped"
        return (f"GemmPlan[{self.m}x{self.n}x{self.k} {self.dtype} "
                f"-> {self.backend}, blocks=({self.block_m},{self.block_n},"
                f"{self.block_k}), lever={self.lever}, pack={self.pack}"
                f"{epi}]")
