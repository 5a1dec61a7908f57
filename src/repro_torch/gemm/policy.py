"""Shape-resolved dispatch policy and the LRU plan cache.

The paper's two levers, chosen per shape:

  * K >= N  -> ``lever="fine_panels"``: block_n sized for grid occupancy
               by the scheduler model; a per-call pack is acceptable.
  * N > K   -> ``lever="prepack"``: deep-K blocks, weight packed at load.

The decode arm (``decode_lane()`` scope) pins an 8-row block_m, forces the
prepack and scores split-K at the canonical decode M.  The quantized arm
(``weight_format`` "int8" | "ternary") fits the tile budget with the
format's bytes per weight element and ``GROUP_K``-aligned block_k, and
admits only weights quantize-packed at load.  ``plan()`` resolves
once per key and memoises in a bounded LRU cache.  The policy is the
reference's, constants included, so plans equal ``repro.gemm.plan``'s.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import warnings
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core import bitexact, packing, scheduler
from repro_torch.gemm import backends as _backends
from repro_torch.gemm.plan import (EpilogueSpec, GemmPlan, LEVER_FINE_PANELS,
                                   LEVER_PREPACK, PACK_NONE, PACK_PERCALL,
                                   PACK_PREPACKED)
from repro_torch.kernels import panel_gemm as _kernel
from repro_torch.kernels import ref as _ref
from repro_torch.quant.formats import _check_fmt
from repro_torch.quant.kernels import quant_gate

# Parallel compute units the fine-panel lever scores against (the
# reference's setting, kept so plans match it).
DEFAULT_NUM_CORES = 8

FINE_BLOCK_N_CANDIDATES = (128, 256, 512)
FINE_BLOCK_K = 512

# Split-K slice counts the decode arm scores; resolved per (n, k) at
# DECODE_SPLIT_M_REF, never per operand M, so every decode-bucket plan for
# one weight shares one slice map (serve == generate).
DECODE_SPLIT_K_CANDIDATES = (1, 2, 4, 8)
DECODE_SPLIT_M_REF = 8

_CACHE_MAXSIZE = 512

CacheInfo = collections.namedtuple(
    "CacheInfo", ["hits", "misses", "maxsize", "currsize"])

_cache: "collections.OrderedDict[tuple, GemmPlan]" = collections.OrderedDict()
_cache_lock = threading.Lock()
_counts = {"hits": 0, "misses": 0}
_vmem_warned: set = set()


def plan_cache_info() -> CacheInfo:
    with _cache_lock:
        return CacheInfo(_counts["hits"], _counts["misses"], _CACHE_MAXSIZE,
                         len(_cache))


def vmem_clamped_count() -> int:
    with _cache_lock:
        return sum(1 for p in _cache.values() if p.vmem_clamped)


def plan_cache_clear() -> None:
    """Reset entries, counters and the clamp warn-state."""
    with _cache_lock:
        _cache.clear()
        _counts["hits"] = _counts["misses"] = 0
        _vmem_warned.clear()


def _dtype_name(dtype: Any) -> str:
    """"float32" / "bfloat16" for a torch dtype or its name."""
    return str(dtype).removeprefix("torch.")


# -------------------------------------------------------- decode fast lane
_LANE = threading.local()


@contextlib.contextmanager
def decode_lane() -> Iterator[None]:
    """Scope marking every plan resolved inside as a DECODE dispatch."""
    depth = getattr(_LANE, "depth", 0)
    _LANE.depth = depth + 1
    try:
        yield
    finally:
        _LANE.depth = depth


def in_decode_lane() -> bool:
    return getattr(_LANE, "depth", 0) > 0


# ------------------------------------------------------------ lever logic
def _fine_block_n(m: int, n: int, k: int, *, block_m: int, block_k: int,
                  num_cores: int) -> int:
    """Occupancy-sized column panel: the candidate width with the best
    scheduler-predicted time (ties toward finer panels)."""
    cands = sorted({packing.fit_block(n, c) for c in FINE_BLOCK_N_CANDIDATES})

    def score(bn: int):
        p = scheduler.plan(m, n, k, block_m=block_m, block_n=bn,
                           block_k=block_k, num_cores=num_cores)
        return (p.t_pred, bn)

    return min(cands, key=score)


def _warn_vmem_clamp(key: tuple, requested: tuple, got: tuple):
    if key in _vmem_warned:
        return
    _vmem_warned.add(key)
    warnings.warn(
        f"gemm policy clamped the block triple {requested} -> {got} to "
        f"fit the tile budget for plan key {key} (the plan records this "
        f"as vmem_clamped=True)", RuntimeWarning, stacklevel=3)


def _fit_vmem(bm: int, bn: int, bk: int, dtype: str,
              epilogue: EpilogueSpec | None, weight_format: str = "fp32",
              split_k: int = 1):
    """Shrink the block triple until ``vmem_bytes`` fits the budget:
    the deeper of (block_k, block_n) first, halving toward 128.  A
    quantized block_k that halving takes off a 128 multiple drops to 128,
    which keeps whole scale groups and divides every padded K."""
    clamped = False
    quant = weight_format != "fp32"
    while _kernel.vmem_bytes(bm, bn, bk, dtype, epilogue=epilogue,
                             weight_format=weight_format,
                             split_k=split_k) > _kernel.VMEM_BUDGET:
        if bk >= bn and bk > 128:
            bk = max(128, bk // 2)
            if quant and bk % 128:
                bk = 128
        elif bn > 128:
            bn = max(128, bn // 2)
        elif bm > 8:
            bm = max(8, bm // 2)
        else:
            break
        clamped = True
    return bm, bn, bk, clamped


def _decode_split_k(n: int, k: int, k_pad: int, *, block_m: int,
                    block_n: int, block_k: int, dtype: str, num_cores: int,
                    weight_format: str,
                    epilogue: EpilogueSpec | None) -> int:
    """The decode arm's split-K winner, scored at the canonical decode M
    (a pure function of (n, k, blocks)); candidates must cut the padded K
    into whole block_k slices and fit the budget with their partials."""
    best = (float("inf"), 1)
    for s in DECODE_SPLIT_K_CANDIDATES:
        if k_pad % s or (k_pad // s) % block_k:
            continue
        if s > 1 and _kernel.vmem_bytes(
                block_m, block_n, block_k, dtype, epilogue=epilogue,
                weight_format=weight_format,
                split_k=s) > _kernel.VMEM_BUDGET:
            continue
        p = scheduler.plan(DECODE_SPLIT_M_REF, n, k, block_m=block_m,
                           block_n=block_n, block_k=block_k,
                           num_cores=num_cores, split_k=s)
        if (p.t_pred, s) < best:
            best = (p.t_pred, s)
    return best[1]


def _rnd_up(x: int, mult: int) -> int:
    return max(mult, ((x + mult - 1) // mult) * mult)


def _resolve(m: int, n: int, k: int, *, dtype: str, backend: str,
             num_cores: int, block_m: int | None, block_n: int | None,
             block_k: int | None, pack: str | None, transposed: bool,
             validate: bool, epilogue: EpilogueSpec | None = None,
             fused_n_splits: tuple = (), weight_format: str = "fp32",
             decode: bool = False, split_k: int | None = None) -> GemmPlan:
    bm = block_m or min(_kernel.DEFAULT_BLOCK_M, _rnd_up(m, 8))
    if decode and block_m is None:
        bm = _kernel.DECODE_BLOCK_M
    if k >= n:                              # lever 1: fine panels
        lever = LEVER_FINE_PANELS
        default_pack = PACK_PERCALL
        bk = block_k or packing.fit_block(k, FINE_BLOCK_K)
        bn = block_n or _fine_block_n(m, n, k, block_m=bm, block_k=bk,
                                      num_cores=num_cores)
    else:                                   # lever 2: pre-pack, deep K
        lever = LEVER_PREPACK
        default_pack = PACK_PREPACKED
        bk = block_k or packing.fit_block(k, _kernel.DEFAULT_BLOCK_K)
        bn = block_n or packing.fit_block(n, _kernel.DEFAULT_BLOCK_N)
    if decode:
        # decode is weight-bound: the re-layout is paid at load
        default_pack = PACK_PREPACKED
    if weight_format != "fp32":
        _check_fmt(weight_format)
        # a pack-time format: the weight must be quantize-packed at load
        if pack is not None and pack != PACK_PREPACKED:
            raise ValueError(
                f"weight_format={weight_format!r} is a pack-time format; "
                f"it requires pack={PACK_PREPACKED!r} (got {pack!r})")
        default_pack = PACK_PREPACKED
    pack = pack or default_pack
    if pack not in (PACK_PREPACKED, PACK_PERCALL, PACK_NONE):
        raise ValueError(f"unknown pack decision {pack!r}")
    req = (bm, bn, bk)
    bm, bn, bk, clamped = _fit_vmem(bm, bn, bk, dtype, epilogue,
                                    weight_format,
                                    1 if split_k is None else int(split_k))
    if clamped:
        _warn_vmem_clamp((m, n, k, dtype, backend, weight_format), req,
                         (bm, bn, bk))
    grid_backend = _backends.get_backend(backend).needs_blocks
    k_pad = _rnd_up(k, bk) if (pack != PACK_NONE or grid_backend) else k
    if split_k is None:
        # the split lever targets the panel-grid backends only
        split_k = (_decode_split_k(n, k, k_pad, block_m=bm, block_n=bn,
                                   block_k=bk, dtype=dtype,
                                   num_cores=num_cores,
                                   weight_format=weight_format,
                                   epilogue=epilogue)
                   if decode and grid_backend else 1)
    split_k = int(split_k)
    if split_k < 1 or k_pad % split_k or (split_k > 1
                                          and (k_pad // split_k) % bk):
        raise ValueError(
            f"split_k={split_k} does not cut the dispatch-time K={k_pad} "
            f"into whole block_k={bk} slices")
    sched = scheduler.plan(m, n, k, block_m=bm, block_n=bn, block_k=bk,
                           num_cores=num_cores, split_k=split_k)
    validated = False
    if validate:
        if weight_format != "fp32":
            ok = quant_gate(bm, bn, bk, weight_format, epilogue=epilogue,
                            split_k=split_k)
        else:
            ok = _bitexact_gate(bm, bn, bk, epilogue=epilogue,
                                split_k=split_k)
        if not ok:
            raise RuntimeError(
                f"blocks ({bm},{bn},{bk}) failed the bit-exactness gate "
                f"(epilogue={epilogue}, weight_format={weight_format}, "
                f"split_k={split_k})")
        validated = True
    return GemmPlan(m=m, n=n, k=k, dtype=dtype, backend=backend,
                    block_m=bm, block_n=bn, block_k=bk, pack=pack,
                    lever=lever, t_pred=sched.t_pred,
                    occupancy=sched.occupancy, transposed=transposed,
                    validated=validated, epilogue=epilogue,
                    fused_n_splits=fused_n_splits, vmem_clamped=clamped,
                    weight_format=weight_format, split_k=split_k,
                    decode=decode)


# --------------------------------------- chunked-prefill plan-key buckets
PREFILL_M_BUCKETS = (8, 16, 32, 64, 128)
DECODE_M_BUCKETS = (1, 2, 4, 8)


def bucket_m(m: int, *, decode: bool = False) -> int:
    """Smallest static bucket holding ``m`` rows (decode buckets first
    when ``decode``); beyond the last, the next multiple of 128."""
    if m < 1:
        raise ValueError(f"m={m}: need at least one row")
    if decode:
        for b in DECODE_M_BUCKETS:
            if m <= b:
                return b
    for b in PREFILL_M_BUCKETS:
        if m <= b:
            return b
    return _rnd_up(m, 128)


# --------------------------------------------------------- bit-exact gate
_gate_memo: dict[tuple, bool] = {}


def _bitexact_gate(bm: int, bn: int, bk: int, *,
                   epilogue: EpilogueSpec | None = None,
                   reduced_k_blocks: int = 2, seed: int = 0,
                   split_k: int = 1) -> bool:
    """The reject protocol for one block triple, on the plain emulator: on
    a reduced shape with a real K carry, the fused plain path must be
    bit-identical to the unfused oracle (blocked or split-K accumulator,
    then ``apply_epilogue``, then the cast).  Memoised."""
    key = (bm, bn, bk, epilogue, split_k)
    if key in _gate_memo:
        return _gate_memo[key]
    rng = np.random.default_rng(seed)
    glu = epilogue is not None and epilogue.glu is not None
    m_r, k_r = bm, reduced_k_blocks * bk * split_k
    n_r = 2 * bn if glu else bn
    x = torch.from_numpy(rng.standard_normal((m_r, k_r), np.float32))
    w = torch.from_numpy(rng.standard_normal((k_r, n_r), np.float32))
    bias = res = None
    if epilogue is not None:
        n_out = bn if glu else n_r
        if epilogue.bias:
            bias = torch.from_numpy(rng.standard_normal((n_r,), np.float32))
        if epilogue.residual:
            res = torch.from_numpy(
                rng.standard_normal((m_r, n_out), np.float32))
    y = _kernel.panel_gemm_splitk_plain(x, w, bias, res, split_k=split_k,
                                        block_k=bk, epilogue=epilogue)
    oracle = _ref.gemm_splitk(x, w, bk, split_k, out_dtype=torch.float32)
    if epilogue is not None and not epilogue.is_noop:
        oracle = _kernel.apply_epilogue(oracle, epilogue, bias=bias,
                                        residual=res)
    ok = bitexact.bit_identical(y, oracle.to(x.dtype))
    _gate_memo[key] = ok
    return ok


# ------------------------------------------------------------- public API
def plan(m: int, n: int, k: int, *, dtype: Any = torch.float32,
         backend: str | None = None, device=None,
         num_cores: int = DEFAULT_NUM_CORES,
         block_m: int | None = None, block_n: int | None = None,
         block_k: int | None = None, pack: str | None = None,
         transposed: bool = False, validate: bool = False,
         epilogue: EpilogueSpec | None = None, fused_n_splits: tuple = (),
         weight_format: str = "fp32", decode: bool | None = None,
         split_k: int | None = None) -> GemmPlan:
    """Resolve (and cache) the dispatch plan for ``[m,k] @ [k,n]``.

    ``backend=None`` takes the innermost ``use_backend`` scope, else the
    default for ``device`` (``cuda`` for a CUDA device, ``plain``
    otherwise).  Explicit ``block_*`` / ``pack`` override the policy;
    ``validate=True`` runs the bit-exactness gate (``quant_gate`` for a
    quantized ``weight_format``).  ``decode=None`` reads the ambient
    :func:`decode_lane` scope."""
    if decode is None:
        decode = in_decode_lane()
    backend = _backends.resolve_backend(backend, device)
    dtype = _dtype_name(dtype)
    if epilogue is not None and epilogue.is_noop:
        epilogue = None
    fused_n_splits = tuple(int(s) for s in fused_n_splits)
    key = (int(m), int(n), int(k), dtype, backend, num_cores, block_m,
           block_n, block_k, pack, bool(transposed), bool(validate),
           epilogue, fused_n_splits, weight_format, bool(decode), split_k)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            _counts["hits"] += 1
            _cache.move_to_end(key)
            return hit
        _counts["misses"] += 1
    p = _resolve(int(m), int(n), int(k), dtype=dtype, backend=backend,
                 num_cores=num_cores, block_m=block_m, block_n=block_n,
                 block_k=block_k, pack=pack, transposed=bool(transposed),
                 validate=validate, epilogue=epilogue,
                 fused_n_splits=fused_n_splits, weight_format=weight_format,
                 decode=bool(decode), split_k=split_k)
    with _cache_lock:
        _cache[key] = p
        _cache.move_to_end(key)
        while len(_cache) > _CACHE_MAXSIZE:
            _cache.popitem(last=False)
    return p


def plan_for_packed(m: int, pw: packing.PackedWeight, *,
                    backend: str | None = None,
                    num_cores: int = DEFAULT_NUM_CORES,
                    validate: bool = False,
                    epilogue: EpilogueSpec | None = None,
                    decode: bool | None = None) -> GemmPlan:
    """Plan for a weight packed at load: the pack's blocks are adopted,
    its split map, its quantized format (``weight_format``) and the
    requested epilogue ride onto the plan, and the default backend follows
    the pack's device.  A quantized pack keys as the fp32 its dequant
    produces (codes are not an operand dtype)."""
    fmt = getattr(pw, "fmt", "fp32")
    return plan(m, pw.n, pw.k,
                dtype=pw.dtype if fmt == "fp32" else torch.float32,
                backend=backend, device=pw.device, num_cores=num_cores,
                block_n=pw.block_n, block_k=pw.block_k, pack=PACK_PREPACKED,
                validate=validate, epilogue=epilogue,
                fused_n_splits=pw.n_splits, weight_format=fmt,
                decode=decode)


def pack_blocks(n: int, k: int, *, m_hint: int = 128,
                block_n: int | None = None, block_k: int | None = None,
                num_cores: int = DEFAULT_NUM_CORES,
                epilogue: EpilogueSpec | None = None,
                weight_format: str = "fp32") -> tuple[int, int]:
    """The load-time pack decision, policy-resolved: (block_n, block_k)
    for a [k, n] weight at the serving M ``m_hint``, in its pack format."""
    p = plan(m_hint, n, k, block_n=block_n, block_k=block_k,
             num_cores=num_cores, epilogue=epilogue,
             weight_format=weight_format)
    return p.block_n, p.block_k
