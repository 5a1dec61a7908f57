"""The quantization error ledger: every concrete quantized pack is probed
against its fp32 weight, the per-(shape, format) error is recorded, and
the format's tolerance is enforced at pack time (the port of
``repro.quant.ledger``).

One entry per ``(n, k, fmt)``:

  * ``max_abs`` -- max |y_quant - y_fp32| over the probe GEMM's output;
  * ``max_rel`` -- ``max_abs / max |y_fp32|`` (normalised by the output's
    own magnitude, so near-zero outputs do not blow the metric up);
  * ``tol``     -- the format's declared ``max_rel`` tolerance.

``gemm.validate_plan`` rejects a quantized plan whose ledger entry
exceeds its tolerance.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

# Per-format max_rel tolerances, the reference's: int8 lands near
# 1e-3..9e-3 on gaussian weights; ternary's 2-bit reconstruction puts the
# output-normalised error near 0.4-0.5, and above 0.75 the quantizer, not
# the format, is broken.
TOLERANCES = {"int8": 1e-2, "ternary": 0.75}

# Probe rows: enough for stable max statistics, cheap at model load.
PROBE_M = 64


class QuantToleranceError(RuntimeError):
    """A quantized pack's measured error exceeded its format tolerance."""


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    n: int
    k: int
    fmt: str
    max_abs: float
    max_rel: float
    tol: float
    probe_m: int

    @property
    def within_tol(self) -> bool:
        return self.max_rel <= self.tol


_entries: dict[tuple[int, int, str], LedgerEntry] = {}
_lock = threading.Lock()


def tolerance(fmt: str) -> float:
    try:
        return TOLERANCES[fmt]
    except KeyError:
        raise KeyError(f"no tolerance declared for format {fmt!r}; "
                       f"known: {sorted(TOLERANCES)}") from None


def record(entry: LedgerEntry) -> LedgerEntry:
    with _lock:
        _entries[(entry.n, entry.k, entry.fmt)] = entry
    return entry


def lookup(n: int, k: int, fmt: str) -> LedgerEntry | None:
    with _lock:
        return _entries.get((int(n), int(k), fmt))


def entries() -> list[LedgerEntry]:
    with _lock:
        return sorted(_entries.values(), key=lambda e: (e.fmt, e.k, e.n))


def clear() -> None:
    with _lock:
        _entries.clear()


def measure(w_fp32: torch.Tensor, qpw, *, enforce: bool = True,
            probe_m: int = PROBE_M) -> LedgerEntry:
    """Probe one quantized pack against its fp32 weight, on the pack's
    device, and record the entry.

    The probe ``x [probe_m, K]`` is a gaussian from numpy seeded by the
    shape (the reference's probe); the oracle is ``x @ w`` in fp32 and the
    quantized side ``x @ dequantize(pack)``, so the error is the format's,
    not a kernel's.  A stacked ``[L, K, N]`` pack is probed per layer and
    its worst layer becomes the entry."""
    from repro_torch.quant import formats as F
    dev = qpw.data.device
    w = w_fp32.to(device=dev, dtype=torch.float32)
    k, n = int(w.shape[-2]), int(w.shape[-1])
    rng = np.random.default_rng((k * 1_000_003 + n) % (2**31))
    x = torch.from_numpy(
        rng.standard_normal((probe_m, k)).astype(np.float32)).to(dev)
    w3 = w.reshape(-1, k, n)
    deq3 = F.dequantize(qpw)[..., :k, :n].reshape(-1, k, n)
    max_abs = max_rel = 0.0
    for wl, dl in zip(w3, deq3):
        y_ref = torch.matmul(x, wl)
        y_q = torch.matmul(x, dl)
        abs_l = float((y_q - y_ref).abs().max()) if y_ref.numel() else 0.0
        denom = float(y_ref.abs().max()) if y_ref.numel() else 0.0
        rel_l = abs_l / max(denom, 1e-30)
        if rel_l >= max_rel:
            max_abs, max_rel = abs_l, rel_l
    entry = record(LedgerEntry(n=int(qpw.n), k=int(qpw.k), fmt=qpw.fmt,
                               max_abs=max_abs, max_rel=max_rel,
                               tol=tolerance(qpw.fmt), probe_m=probe_m))
    if enforce and not entry.within_tol:
        raise QuantToleranceError(
            f"quantized pack [{qpw.k}x{qpw.n}] fmt={qpw.fmt}: max_rel "
            f"error {max_rel:.3e} exceeds the {qpw.fmt} tolerance "
            f"{entry.tol:.1e}")
    return entry
