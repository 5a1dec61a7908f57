"""Panel-granularity scheduling model (paper lever 1): napkin math that
scores a block triple by grid occupancy, tile footprint and modelled
memory re-reads.

The constants are the REFERENCE's, kept in this slice so that the port's
lever choices and pack layouts equal ``repro.core.scheduler``'s: they are
the policy's inputs here, not a description of the H100 (re-basing them
on ``torch.cuda.get_device_properties`` is a later step).  The predicted
time ``t_pred`` ranks candidates; it is not a measurement of anything.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.kernels.panel_gemm import VMEM_BUDGET, vmem_bytes

# The reference policy's model constants (see module docstring).
PEAK_FLOPS = 197e12
PEAK_FLOPS_F32 = 98.5e12
HBM_BW = 819e9
MXU_LANE = 128
GRID_STEP_OVERHEAD = 1e-8


@dataclasses.dataclass(frozen=True)
class PanelPlan:
    block_m: int
    block_n: int
    block_k: int
    grid: tuple[int, int, int]
    panels: int                 # parallel (i, j[, s]) output panels
    vmem: int
    vmem_ok: bool
    aligned: bool               # 128-lane alignment
    hbm_bytes: float            # modelled traffic incl. panel re-reads
    t_compute: float
    t_memory: float
    t_pred: float               # max(compute, memory) / occupancy
    occupancy: float            # parallel-panel tail utilization
    split_k: int = 1


def plan(m: int, n: int, k: int, *, block_m: int, block_n: int,
         block_k: int, dtype_bytes: int = 4, num_cores: int = 1,
         peak_flops: float = PEAK_FLOPS_F32, split_k: int = 1) -> PanelPlan:
    """Score one block triple; ``split_k > 1`` scores the decode lane's
    reduction-side panels, paid for by the partials round trip and the
    combine adds."""
    gm, gn, gk = (math.ceil(m / block_m), math.ceil(n / block_n),
                  math.ceil(k / block_k))
    panels = gm * gn * split_k
    waves = math.ceil(panels / num_cores)
    occ = panels / (waves * num_cores)
    vm = vmem_bytes(block_m, block_n, block_k, split_k=split_k)
    hbm = dtype_bytes * (m * k * gn + k * n * gm + 2 * m * n)
    t_c = 2.0 * m * n * k / (peak_flops * num_cores)
    if split_k > 1:
        hbm += 2.0 * 4 * split_k * m * n
        t_c += 2.0 * (split_k - 1) * m * n / (peak_flops * num_cores)
    t_m = hbm / (HBM_BW * num_cores)
    aligned = (block_m % 8 == 0 and block_n % MXU_LANE == 0
               and block_k % MXU_LANE == 0)
    t_o = GRID_STEP_OVERHEAD * gm * gn * gk / num_cores
    t = (max(t_c, t_m) + t_o) / max(occ, 1e-9)
    if not aligned:
        t *= 4.0
    if vm > VMEM_BUDGET:
        t = float("inf")
    return PanelPlan(block_m, block_n, block_k, (gm, gn, gk), panels, vm,
                     vm <= VMEM_BUDGET, aligned, hbm, t_c, t_m, t, occ,
                     split_k)
