"""Panel GEMM: the fp32 lane's two CUDA kernels, their plain versions, and
the epilogue they share.

``panel_gemm`` (prefill, and decode at ``split_k = 1``) and
``panel_gemm_splitk`` (the decode lane) are the wrappers of the
hand-written kernels in ``csrc/panel_gemm.cu``; they replace the Pallas
kernels of ``repro.kernels.panel_gemm`` of the same names.  Each wrapper
checks its operands, allocates its outputs, launches on the current
stream, raises if the launch failed, and counts its launches in
``<wrapper>.launches``.  Given CPU tensors a wrapper runs its plain
version instead (``panel_gemm_plain`` / ``panel_gemm_splitk_plain``);
given CUDA tensors it launches the kernel or raises.

The plain versions compute the same function in plain torch ops, as the
fixed-tile emulator of ``kernels/ref.py``: deterministic and
batch-invariant on any device, the only GEMM of the CPU ``plain``
backend, and the kernels' oracle on the card.  Kernel and plain version
sum K in different orders, so they agree within the bound of
``gemm_error_bound``, not bit for bit.

The epilogue (``EpilogueSpec``) runs on the fp32 accumulator in the
reference's order: bias -> activation (or the glu combine
``act(gate) * up`` over the two column halves of one fused weight) ->
tanh softcap -> residual, then one cast.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib, ref

# The reference policy's block pair and row panels.  They fix the pack's
# padding (every padded dim is a multiple of 128), the K-block order of
# the plain version and the split-K slice map; the CUDA kernels tile with
# their own, smaller CTA tiles (see csrc/panel_gemm.cu).
DEFAULT_BLOCK_M = 128     # the paper's M = S = 128 prefill row panel
DEFAULT_BLOCK_N = 512     # column-panel width (lever-1 knob)
DEFAULT_BLOCK_K = 2048    # K-blocking depth (lever-2-unlocked knob)
DECODE_BLOCK_M = 8        # decode rows pad to one 8-row panel

# Tile budget of the reference policy (bytes): the port keeps the
# reference's policy constants in this slice so that its lever choices and
# pack layouts equal the reference's (checked by tests/test_torch_gemm.py).
VMEM_BUDGET = 16 * 1024 * 1024


# ------------------------------------------------------------- epilogue
_EPI_ACTS = ("silu", "gelu", "tanh")
_ACT_CODE = {None: 0, "silu": 1, "gelu": 2, "tanh": 3}   # csrc enum Act


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Statically planned epilogue applied on the fp32 accumulator at the
    kernel's single store step.  ``bias`` / ``residual`` are flags; the
    operands ride the call."""
    bias: bool = False
    act: str | None = None          # "silu" | "gelu" | "tanh"
    softcap: float | None = None    # cap * tanh(x / cap)
    residual: bool = False
    glu: str | None = None          # activation of the gate half

    def __post_init__(self):
        for name in (self.act, self.glu):
            if name is not None and name not in _EPI_ACTS:
                raise ValueError(f"unknown epilogue activation {name!r}; "
                                 f"choose from {_EPI_ACTS}")
        if self.act is not None and self.glu is not None:
            raise ValueError("act and glu are mutually exclusive (glu "
                             "already applies its activation to the gate)")

    @property
    def is_noop(self) -> bool:
        return not (self.bias or self.act or self.softcap is not None
                    or self.residual or self.glu)


def round_once(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` evaluated in float64 and rounded once to x's dtype.

    PyTorch's vectorised CPU kernels compute a transcendental op on the
    tail of a tensor with scalar code, which may differ from the vector
    code in the last bit, so an element's fp32 ``exp`` could depend on
    where it sits in the tensor, and therefore on the batch.  In float64
    both codes are accurate far below fp32's resolution, and one rounding
    gives each element the same fp32 value wherever it sits."""
    return fn(x.double()).to(x.dtype)


_GELU_C = 0.7978845608028654        # sqrt(2 / pi)


def _gelu_tanh(x):
    # the tanh form with x*x*x, as the reference and the CUDA epilogue
    return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x))))


_ACTS = {"silu": F.silu, "gelu": _gelu_tanh, "tanh": torch.tanh}


def act_fn(name: str):
    """The package-wide activation table, shared by the plain epilogue and
    the unfused ``models.layers`` ops.  Unknown names raise."""
    if name not in _ACTS:
        raise ValueError(f"unknown activation {name!r}; choose from "
                         f"{_EPI_ACTS}")
    fn = _ACTS[name]
    return lambda x: round_once(fn, x)


def _finish(spec: EpilogueSpec, acc, residual):
    """Post-activation steps.  Softcap multiplies by the reciprocal
    ``1/cap`` (computed in double, rounded to fp32 once), as the kernel
    does."""
    if spec.softcap is not None:
        acc = spec.softcap * round_once(torch.tanh,
                                        acc * (1.0 / spec.softcap))
    if spec.residual:
        acc = acc + residual
    return acc


def apply_epilogue_glu(g, u, spec: EpilogueSpec, *, bias_g=None,
                       bias_u=None, residual=None):
    """The glu epilogue on pre-split gate/up fp32 accumulators."""
    g = g.float()
    u = u.float()
    if spec.bias:
        g = g + bias_g.float()
        u = u + bias_u.float()
    acc = act_fn(spec.glu)(g) * u
    res = residual.float() if spec.residual else None
    return _finish(spec, acc, res)


def apply_epilogue(acc, spec: EpilogueSpec, *, bias=None, residual=None):
    """The epilogue on a full fp32 accumulator (for glu, the full fused
    width; the halves are combined here)."""
    acc = acc.float()
    if spec.glu is not None:
        half = acc.shape[-1] // 2
        b = bias.float() if spec.bias else None
        return apply_epilogue_glu(
            acc[..., :half], acc[..., half:], spec,
            bias_g=b[..., :half] if spec.bias else None,
            bias_u=b[..., half:] if spec.bias else None,
            residual=residual)
    if spec.bias:
        acc = acc + bias.float()
    if spec.act is not None:
        acc = act_fn(spec.act)(acc)
    res = residual.float() if spec.residual else None
    return _finish(spec, acc, res)


def splitk_combine(parts) -> torch.Tensor:
    """Fixed-order pairwise tree sum of split-K partials, (p0+p1)+(p2+p3)...

    ``parts``: a list of fp32 ``[M, N]`` partials or a stacked
    ``[split_k, M, N]`` tensor, in slice order.  The result is a pure
    function of the partial values, whichever code produced them."""
    if isinstance(parts, torch.Tensor):
        parts = list(parts.unbind(0))
    parts = list(parts)
    if not parts:
        raise ValueError("splitk_combine needs at least one partial")
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts)
                 else parts[i] for i in range(0, len(parts), 2)]
    return parts[0]


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def vmem_bytes(block_m: int, block_n: int, block_k: int,
               in_dtype=torch.float32, *,
               epilogue: EpilogueSpec | None = None,
               weight_format: str = "fp32",
               split_k: int = 1) -> int:
    """The reference's tile-footprint model for one grid step
    (double-buffered inputs), which the policy clamps blocks against.  A
    quantized pack streams ``weight_itemsize`` bytes per weight element
    plus its fp32 scale rows.  The CUDA kernels tile with their own
    smaller CTA tiles; the model stays so that the port's plans equal the
    reference's."""
    isz = _itemsize(in_dtype)
    x = block_m * block_k * isz
    if weight_format == "fp32":
        w = block_k * block_n * isz
        scales = 0
    else:
        from repro_torch.quant.formats import GROUP_K, weight_itemsize
        w = int(block_k * block_n * weight_itemsize(weight_format))
        scales = max(1, block_k // GROUP_K) * block_n * 4
    acc = block_m * block_n * 4
    out = block_m * block_n * isz
    glu = epilogue is not None and epilogue.glu is not None
    if glu:
        w *= 2
        scales *= 2
        acc *= 2
    extra = block_n * 4 * (2 if glu else 1) + block_m * block_n * 4
    if split_k > 1:
        extra += split_k * block_m * block_n * 4
    return 2 * (x + w + scales) + acc + out + extra


# --------------------------------------------------------- operand checks
def _spec(epilogue: EpilogueSpec | None) -> EpilogueSpec | None:
    return None if epilogue is None or epilogue.is_noop else epilogue


def _geometry(x, w_shape, bias, residual, spec, *, block_m, block_n,
              block_k, split_k=1):
    """Shapes against blocks (the reference's asserts, raised as
    ValueError); ``w_shape`` is the (unpacked) weight's [K, N].  Returns
    (m, k, n, n_out)."""
    if x.dim() != 2 or len(w_shape) != 2:
        raise ValueError(f"x and w must be 2-D; got {tuple(x.shape)} and "
                         f"{tuple(w_shape)}")
    m, k = x.shape
    k2, n = w_shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if split_k < 1 or k % split_k:
        raise ValueError(f"K={k} not divisible by split_k={split_k}")
    if m % block_m or n % block_n or (k // split_k) % block_k:
        raise ValueError(
            f"shapes ({m},{n},{k}) / slice depth {k // split_k} not "
            f"aligned to blocks ({block_m},{block_n},{block_k}); pack first")
    glu = spec is not None and spec.glu is not None
    n_out = n // 2 if glu else n
    if glu and (n % 2 or n_out % block_n):
        raise ValueError(f"glu epilogue needs block-aligned column halves; "
                         f"got N={n} with block_n={block_n}")
    if (bias is not None) != bool(spec is not None and spec.bias):
        raise ValueError(f"bias operand vs epilogue {spec}")
    if (residual is not None) != bool(spec is not None and spec.residual):
        raise ValueError(f"residual operand vs epilogue {spec}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} vs N={n}")
    if residual is not None and tuple(residual.shape) != (m, n_out):
        raise ValueError(f"residual {tuple(residual.shape)} vs output "
                         f"({m},{n_out})")
    return m, k, n, n_out


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(x, w, bias, residual, out_dtype):
    """What the CUDA kernels take: every operand on x's CUDA device and
    contiguous, x fp32 or bf16, w / bias / residual fp32, output fp32 or
    bf16."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA operands; x is on "
                         f"{x.device}")
    ops = {"x": x, "w": w, "bias": bias, "residual": residual}
    for name, t in ops.items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = _KERNEL_DTYPES if name == "x" else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"{name} dtype {t.dtype}; the kernel takes "
                            f"{want}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"out_dtype {out_dtype}; the kernel stores "
                        f"{_KERNEL_DTYPES}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(what: str, err: int):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


# --------------------------------------------------------- panel_gemm
def panel_gemm_plain(x, w, bias=None, residual=None, *,
                     block_k: int = DEFAULT_BLOCK_K, out_dtype=None,
                     epilogue: EpilogueSpec | None = None):
    """The plain version of ``panel_gemm``: the blocked emulator's fp32
    accumulator, then the epilogue, then one cast."""
    spec = _spec(epilogue)
    acc = ref.gemm_blocked(x, w, block_k, out_dtype=torch.float32)
    if spec is not None:
        acc = apply_epilogue(acc, spec, bias=bias, residual=residual)
    return acc.to(out_dtype or x.dtype)


def panel_gemm(x, w, bias=None, residual=None, *,
               block_m: int = DEFAULT_BLOCK_M,
               block_n: int = DEFAULT_BLOCK_N,
               block_k: int = DEFAULT_BLOCK_K, out_dtype=None,
               epilogue: EpilogueSpec | None = None):
    """C[M, N_out] = epilogue(x @ w) on pre-padded operands: x
    ``[M_pad, K_pad]``, w the packed ``[K_pad, N_pad]``; with a glu
    epilogue w holds [gate | up] halves and N_out = N_pad / 2.  CUDA
    operands launch ``repro_panel_gemm``; CPU operands run
    :func:`panel_gemm_plain`."""
    spec = _spec(epilogue)
    m, k, n, n_out = _geometry(x, tuple(w.shape), bias, residual, spec,
                               block_m=block_m, block_n=block_n,
                               block_k=block_k)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return panel_gemm_plain(x, w, bias, residual, block_k=block_k,
                                out_dtype=out_dtype, epilogue=spec)
    _check_cuda(x, w, bias, residual, out_dtype)
    s = spec or EpilogueSpec()
    cap = s.softcap if s.softcap is not None else 0.0
    rcp = 1.0 / s.softcap if s.softcap is not None else 0.0
    lib = cuda_lib.load()
    with torch.cuda.device(x.device):
        out = torch.empty((m, n_out), dtype=out_dtype, device=x.device)
        err = lib.repro_panel_gemm(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            _ptr(bias), _ptr(residual), out.data_ptr(),
            int(out_dtype == torch.bfloat16), m, k, n, n_out,
            _ACT_CODE[s.act], _ACT_CODE[s.glu], int(s.softcap is not None),
            cap, rcp, torch.cuda.current_stream(x.device).cuda_stream)
    _launched("panel_gemm", err)
    panel_gemm.launches += 1
    return out


panel_gemm.launches = 0


# ----------------------------------------------------------- split-K lane
def panel_gemm_splitk_plain(x, w, bias=None, residual=None, *, split_k: int,
                            block_k: int = DEFAULT_BLOCK_K, out_dtype=None,
                            epilogue: EpilogueSpec | None = None):
    """The plain version of ``panel_gemm_splitk``: per-slice blocked
    partials, the fixed combine tree, the epilogue, one cast."""
    spec = _spec(epilogue)
    acc = ref.gemm_splitk(x, w, block_k, split_k, out_dtype=torch.float32)
    if spec is not None:
        acc = apply_epilogue(acc, spec, bias=bias, residual=residual)
    return acc.to(out_dtype or x.dtype)


def panel_gemm_splitk(x, w, bias=None, residual=None, *, split_k: int,
                      block_m: int = DECODE_BLOCK_M,
                      block_n: int = DEFAULT_BLOCK_N,
                      block_k: int = DEFAULT_BLOCK_K, out_dtype=None,
                      epilogue: EpilogueSpec | None = None):
    """C = epilogue(splitk_combine(per-slice x @ w)), the decode lane.
    CUDA operands launch ``repro_panel_gemm_splitk`` for the fp32
    partials ``[split_k, M, N]``; the combine tree and the epilogue then
    run as plain torch ops, as in the reference.  CPU operands run
    :func:`panel_gemm_splitk_plain`."""
    spec = _spec(epilogue)
    m, k, n, _ = _geometry(x, tuple(w.shape), bias, residual, spec,
                           block_m=block_m, block_n=block_n,
                           block_k=block_k, split_k=split_k)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return panel_gemm_splitk_plain(x, w, bias, residual,
                                       split_k=split_k, block_k=block_k,
                                       out_dtype=out_dtype, epilogue=spec)
    _check_cuda(x, w, bias, residual, out_dtype)
    lib = cuda_lib.load()
    with torch.cuda.device(x.device):
        partials = torch.empty((split_k, m, n), dtype=torch.float32,
                               device=x.device)
        err = lib.repro_panel_gemm_splitk(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            partials.data_ptr(), m, k, n, split_k,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched("panel_gemm_splitk", err)
    panel_gemm_splitk.launches += 1
    acc = splitk_combine(partials)
    if spec is not None:
        acc = apply_epilogue(acc, spec, bias=bias, residual=residual)
    return acc.to(out_dtype)


panel_gemm_splitk.launches = 0


# ------------------------------------------------------------ tolerance
_U = 2.0 ** -24            # fp32 unit roundoff
_ACT_SLOPE = 1.2           # >= max |f'| of silu (1.0998), gelu (1.1289), tanh
_IMPL_ULPS = 16.0          # transcendental/rounding differences, in units of _U


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def gemm_error_bound(x, w, *, bias=None, residual=None,
                     epilogue: EpilogueSpec | None = None, out_dtype=None,
                     value=None) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for one panel GEMM call.

    Two fp32 sums of the same K products in different orders differ by at
    most ``2 * K * 2**-24 * (|x| @ |w|)`` (the standard summation bound,
    once for each).  The epilogue carries that through its slope (<= 1.2
    for silu, gelu and tanh; softcap's slope is <= 1); for glu the gate's
    error is scaled by |up| and the up half's by |act(gate)|.  Each side's
    own library functions and roundings add ``16 * 2**-24 * |value|``
    (``value`` is the plain version's fp32 result).  A bf16 output adds
    half a bf16 ulp for each side's rounding, taken at the larger of the
    two magnitudes (the sides may round in neighbouring binades): one ulp
    of ``|value| + err``."""
    spec = _spec(epilogue)
    k = x.shape[1]
    ax = x.float().abs()
    aw = w.float().abs()
    mag = torch.matmul(ax, aw) * (1.0 + 2.0 * k * _U)   # |x| @ |w|, rounded up
    err = 2.0 * k * _U * mag
    if spec is not None and spec.glu is not None:
        half = err.shape[-1] // 2
        acc = ref.gemm_matmul(x.float(), w.float())
        if spec.bias:
            acc = acc + bias.float()
        g, u = acc[:, :half], acc[:, half:]
        err = (_ACT_SLOPE * err[:, :half] * u.abs()
               + act_fn(spec.glu)(g).abs() * err[:, half:]
               + err[:, :half] * err[:, half:])
    elif spec is not None and spec.act is not None:
        err = _ACT_SLOPE * err
    if value is None:
        value = panel_gemm_plain(x, w, bias, residual,
                                 block_k=x.shape[1], out_dtype=torch.float32,
                                 epilogue=spec)
    value = value.float()
    err = err + _IMPL_ULPS * _U * (value.abs() + 1e-30)
    if (out_dtype or x.dtype) == torch.bfloat16:
        err = err + _bf16_ulp(value.abs() + err)
    return err
