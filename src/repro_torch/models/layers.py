"""Shared building blocks.  Every projection goes through ``linear``, so
packed weights (and raw ones, packed per call) dispatch through the
plan/execute GEMM and its kernels.

Batch invariance.  ``Engine.serve`` must return exactly what per-request
``Engine.generate`` returns, although the two run a request's rows in
batches of other shapes.  So no op here lets a row's result depend on the
batch: reductions over a row use :func:`tree_sum` (a fixed pairwise order
that depends on the reduced length only), and transcendental ops run
through ``round_once`` (see ``kernels.panel_gemm``).
"""
from __future__ import annotations

import torch

from repro_torch import gemm as _gemm
from repro_torch.core.packing import PackedWeight
from repro_torch.kernels.panel_gemm import act_fn as _act_fn
from repro_torch.kernels.panel_gemm import round_once


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in a fixed pairwise order: halves are added
    elementwise until one element is left (an odd tail element rides
    along).  The order depends on ``x.shape[dim]`` only, so the result for
    one row is the same whatever else is in the tensor; a library
    reduction may split its sum differently for different shapes."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if n % 2 else y
    return x[..., 0]


def _spec(bias, softcap, residual):
    if bias is None and softcap is None and residual is None:
        return None
    return _gemm.EpilogueSpec(bias=bias is not None, softcap=softcap,
                              residual=residual is not None)


def linear(x: torch.Tensor, w, bias=None, *, softcap: float | None = None,
           residual=None, out_dtype=None) -> torch.Tensor:
    """x[..., K] @ w[K, N] (+ fused epilogue), through plan/execute.  ``w``
    is a ``PackedWeight`` (packed at load, paper lever 2) or a raw [K, N]
    tensor (packed per call).  ``bias`` / ``softcap`` / ``residual``
    become the plan's epilogue, applied on the fp32 accumulator in the
    kernel's store step."""
    spec = _spec(bias, softcap, residual)
    m = _gemm.lead_m(x)
    if isinstance(w, PackedWeight):
        p = _gemm.plan_for_packed(m, w, epilogue=spec)
    else:
        p = _gemm.plan(m, w.shape[1], w.shape[0], dtype=w.dtype,
                       device=w.device, pack=_gemm.PACK_PERCALL,
                       epilogue=spec)
    return _gemm.execute(p, x, w, bias=bias, residual=residual,
                         out_dtype=out_dtype)


def fused_linear(x: torch.Tensor, w: PackedWeight) -> tuple:
    """One GEMM pass over a horizontally fused pack: x is streamed once,
    and the per-part outputs of the static split map come back."""
    p = _gemm.plan_for_packed(_gemm.lead_m(x), w)
    return _gemm.split_fused(p, _gemm.execute(p, x, w))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = tree_sum(x * x) / x.shape[-1]
    x = x * round_once(torch.rsqrt, var + eps)[..., None]
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (x * s).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, D] (D even), positions: [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq
    sin, cos = round_once(torch.sin, ang), round_once(torch.cos, ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, act: str = "silu"):
    """Unfused gated FFN: three GEMM passes, the activation in between."""
    a = _act_fn(act)(linear(x, w_gate))
    return linear(a * linear(x, w_up), w_down)


def swiglu_fused(x, w_gate_up: PackedWeight, w_down, act: str = "silu",
                 residual=None):
    """Gated FFN over a fused gate+up pack: ONE pass carries two
    accumulators and stores ``act(gate) * up`` (the glu epilogue);
    ``residual`` rides the down-projection's epilogue."""
    spec = _gemm.EpilogueSpec(glu=act)
    p = _gemm.plan_for_packed(_gemm.lead_m(x), w_gate_up, epilogue=spec)
    h = _gemm.execute(p, x, w_gate_up)
    return linear(h, w_down, residual=residual)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * round_once(torch.tanh, x * (1.0 / cap))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def init_dense(gen: torch.Generator, shape, scale=None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan-in ** -0.5), drawn from ``gen``
    (a generator on ``device``)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)
