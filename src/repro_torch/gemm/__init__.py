"""Plan/execute GEMM dispatch: the one surface for every GEMM the port runs.

    from repro_torch import gemm

    p = gemm.plan(m, n, k)                 # shape-resolved policy + cache
    pw = gemm.pack_for_plan(p, w)          # pay the pack once (lever 2)
    y = gemm.execute(p, x, pw)             # per call: compute loop only
"""
from repro_torch.gemm.backends import (Backend, UnknownBackendError,
                                       default_backend, get_backend,
                                       list_backends, register_backend,
                                       use_backend)
from repro_torch.gemm.execute import (PlanMismatchError, execute, lead_m,
                                      pack_for_plan, split_fused,
                                      validate_plan)
from repro_torch.gemm.plan import (EpilogueSpec, GemmPlan, LEVER_FINE_PANELS,
                                   LEVER_PREPACK, PACK_NONE, PACK_PERCALL,
                                   PACK_PREPACKED)
from repro_torch.gemm.policy import (DECODE_M_BUCKETS,
                                     DECODE_SPLIT_K_CANDIDATES,
                                     DEFAULT_NUM_CORES, PREFILL_M_BUCKETS,
                                     bucket_m, decode_lane, in_decode_lane,
                                     pack_blocks, plan, plan_cache_clear,
                                     plan_cache_info, plan_for_packed,
                                     vmem_clamped_count)
from repro_torch.kernels.panel_gemm import apply_epilogue, splitk_combine

__all__ = [
    "Backend", "EpilogueSpec", "GemmPlan", "PlanMismatchError",
    "UnknownBackendError", "LEVER_FINE_PANELS", "LEVER_PREPACK",
    "DEFAULT_NUM_CORES", "PACK_NONE", "PACK_PERCALL", "PACK_PREPACKED",
    "PREFILL_M_BUCKETS", "DECODE_M_BUCKETS", "DECODE_SPLIT_K_CANDIDATES",
    "apply_epilogue", "bucket_m", "decode_lane", "default_backend",
    "execute", "get_backend", "in_decode_lane", "lead_m", "list_backends",
    "pack_blocks", "pack_for_plan", "plan", "plan_cache_clear",
    "plan_cache_info", "plan_for_packed", "register_backend",
    "split_fused", "splitk_combine", "use_backend",
    "validate_plan", "vmem_clamped_count",
]
