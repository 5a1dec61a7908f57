"""Backend registry: which code runs a planned GEMM.

  * ``cuda``  -- the hand-written kernels (``kernels.panel_gemm``); the
                 default whenever the operands are on a CUDA device.
  * ``plain`` -- the fixed-tile emulator (the kernels' plain versions);
                 the default, and the only backend, for CPU operands.
  * ``torch`` -- one ``torch.matmul`` per K slice plus the epilogue: the
                 vendor-library baseline on CUDA operands, run only when
                 asked for by name.  It ignores the plan's blocking
                 (``needs_blocks=False``).

Each also has ``run_quant`` for quantized packs: the dequant-fused kernels
(``cuda``), their plain versions (``plain``), or dequantize-then-matmul
(``torch``, the baseline).  A backend registered without ``run_quant``
rejects quantized plans.

``register_backend`` is the extension hook; ``use_backend`` scopes a
choice (the serving Engine wraps its steps in it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Iterator

import torch

from repro_torch.kernels import panel_gemm as _kernel
from repro_torch.quant import formats as _formats
from repro_torch.quant import kernels as _quant

# run(x_p, w_p, *, block_m, block_n, block_k, out_dtype, [epilogue, bias,
#     residual], [split_k]) -> y
# run_quant(x_p, codes, scales, *, weight_format, block_m, block_n, block_k,
#           out_dtype, [epilogue, bias, residual], [split_k]) -> y
RunFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    run: RunFn
    needs_blocks: bool = True    # False: shape-agnostic, skip block padding
    description: str = ""
    run_quant: RunFn | None = None   # None: rejects quantized plans


_REGISTRY: dict[str, Backend] = {}
_LOCK = threading.Lock()
_STATE = threading.local()       # per-thread default-backend override stack


class UnknownBackendError(KeyError):
    pass


def register_backend(name: str, run: RunFn, *, needs_blocks: bool = True,
                     description: str = "", overwrite: bool = False,
                     run_quant: RunFn | None = None) -> Backend:
    """Register a GEMM backend under ``name`` (the extension hook);
    ``run_quant`` is its dequant-fused run for quantized packs."""
    with _LOCK:
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"backend {name!r} already registered; "
                             f"pass overwrite=True to replace it")
        b = Backend(name=name, run=run, needs_blocks=needs_blocks,
                    description=description, run_quant=run_quant)
        _REGISTRY[name] = b
        return b


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown GEMM backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


def default_backend(device=None) -> str:
    """The innermost ``use_backend`` scope, else ``cuda`` for CUDA
    operands and ``plain`` otherwise."""
    stack = getattr(_STATE, "stack", None)
    if stack:
        return stack[-1]
    if device is not None and torch.device(device).type == "cuda":
        return "cuda"
    return "plain"


def resolve_backend(name: str | None, device=None) -> str:
    name = name or default_backend(device)
    get_backend(name)            # validate early, at plan time
    return name


@contextlib.contextmanager
def use_backend(name: str | None) -> Iterator[None]:
    """Scope the default backend; ``None`` is a no-op scope."""
    if name is None:
        yield
        return
    get_backend(name)
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


# ------------------------------------------------------------ builtin runs
def _need_cuda(name, x_p):
    if x_p.device.type != "cuda":
        raise ValueError(f"the {name} backend needs CUDA operands; got "
                         f"{x_p.device} (CPU operands run on 'plain')")


def _run_cuda(x_p, w_p, *, block_m, block_n, block_k, out_dtype,
              epilogue=None, bias=None, residual=None, split_k=1):
    _need_cuda("cuda", x_p)
    if split_k > 1:
        return _kernel.panel_gemm_splitk(
            x_p, w_p, bias, residual, split_k=split_k, block_m=block_m,
            block_n=block_n, block_k=block_k, out_dtype=out_dtype,
            epilogue=epilogue)
    return _kernel.panel_gemm(x_p, w_p, bias, residual, block_m=block_m,
                              block_n=block_n, block_k=block_k,
                              out_dtype=out_dtype, epilogue=epilogue)


def _run_plain(x_p, w_p, *, block_m, block_n, block_k, out_dtype,
               epilogue=None, bias=None, residual=None, split_k=1):
    del block_m, block_n
    return _kernel.panel_gemm_splitk_plain(
        x_p, w_p, bias, residual, split_k=split_k, block_k=block_k,
        out_dtype=out_dtype, epilogue=epilogue)


def _run_torch(x_p, w_p, *, block_m, block_n, block_k, out_dtype,
               epilogue=None, bias=None, residual=None, split_k=1):
    del block_m, block_n, block_k
    _need_cuda("torch", x_p)
    k = x_p.shape[-1]
    ks = k // split_k
    xf, wf = x_p.float(), w_p.float()
    acc = _kernel.splitk_combine(
        [torch.matmul(xf[:, s * ks:(s + 1) * ks], wf[s * ks:(s + 1) * ks])
         for s in range(split_k)])
    if epilogue is not None:
        acc = _kernel.apply_epilogue(acc, epilogue, bias=bias,
                                     residual=residual)
    return acc.to(out_dtype or x_p.dtype)


def _run_quant_cuda(x_p, codes, scales, *, weight_format, block_m, block_n,
                   block_k, out_dtype, epilogue=None, bias=None,
                   residual=None, split_k=1):
    _need_cuda("cuda", x_p)
    kw = dict(weight_format=weight_format, block_m=block_m,
              block_n=block_n, block_k=block_k, out_dtype=out_dtype,
              epilogue=epilogue)
    if split_k > 1:
        return _quant.quant_panel_gemm_splitk(x_p, codes, scales, bias,
                                              residual, split_k=split_k,
                                              **kw)
    return _quant.quant_panel_gemm(x_p, codes, scales, bias, residual, **kw)


def _run_quant_plain(x_p, codes, scales, *, weight_format, block_m, block_n,
                     block_k, out_dtype, epilogue=None, bias=None,
                     residual=None, split_k=1):
    del block_m, block_n
    return _quant.quant_panel_gemm_splitk_plain(
        x_p, codes, scales, bias, residual, weight_format=weight_format,
        split_k=split_k, block_k=block_k, out_dtype=out_dtype,
        epilogue=epilogue)


def _run_quant_torch(x_p, codes, scales, *, weight_format, block_m, block_n,
                     block_k, out_dtype, epilogue=None, bias=None,
                     residual=None, split_k=1):
    """The dequantize-then-matmul baseline: the fp32 weight is made in
    device memory, then the ``torch`` run multiplies it."""
    w = _formats.dequantize_padded(codes, scales, weight_format)
    return _run_torch(x_p, w, block_m=block_m, block_n=block_n,
                      block_k=block_k, out_dtype=out_dtype,
                      epilogue=epilogue, bias=bias, residual=residual,
                      split_k=split_k)


register_backend("cuda", _run_cuda,
                 description="hand-written CUDA panel kernels (sm_90a)",
                 run_quant=_run_quant_cuda)
register_backend("plain", _run_plain,
                 description="fixed-tile emulator (the kernels' plain "
                             "versions; CPU operands)",
                 run_quant=_run_quant_plain)
register_backend("torch", _run_torch, needs_blocks=False,
                 description="torch.matmul + epilogue (library baseline)",
                 run_quant=_run_quant_torch)
