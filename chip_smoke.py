#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  -- the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   -- nvcc builds ``src/repro_torch/csrc/*.cu`` into ``build/``,
              one process per source, all started together.
3. kernels -- each hand-written kernel at the main path's shapes
              (deepseek-7b's five fp32 packs, and its four quantized packs
              in int8 and in ternary plus the unfused ``w_gate`` of the
              split-K decode lane, at prefill M = 128 and decode M = 4; and
              one small shape per epilogue variant) against its plain
              PyTorch version on the same inputs, within the bound of
              ``kernels.panel_gemm.gemm_error_bound``; two launches bitwise
              equal; rows of an M = 128 launch bitwise equal to the same
              rows launched at M = 8; and a dequant-fused kernel bitwise
              equal to the fp32 kernel on the dequantized weight.  Then
              timed (CUDA events, L2 flushed before every launch, median of
              20 after 2 warm-up calls): the kernel, its plain version, a
              library yardstick with TF32 off (one ``torch.matmul`` of the
              same product; for a quantized weight, dequantize then
              ``torch.matmul``), and the bound (fp32 FMA peak or HBM
              bandwidth, from NVIDIA's data sheet for the card).
4. serve   -- deepseek-7b at full width and depth (30 layers) on seeded
              random weights, four engines in turn: fp32, int8 and ternary
              (fused packs, head and embeddings kept fp32) and int8 with
              ``fuse=False`` (whose gate and up decode through the split-K
              kernel).  Each runs ``Engine.generate`` per request, then
              ``Engine.serve`` on the same 4 requests (batch_slots=2,
              prefill_chunk=32, page_size=16, 8 new tokens); serve must
              equal generate token for token, and every kernel of that
              path must have launched during its run.  Then an 8-token
              prefill through the served model's first 2 layers and its
              head, in fp32 compute, through the kernels and through the
              plain backend, must agree within a stated bound.


The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  A full report goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # name: (source in the repo, the TPU kernel it replaces)
    "panel_gemm": ("src/repro_torch/csrc/panel_gemm.cu",
                   "src/repro/kernels/panel_gemm.py:364"),
    "panel_gemm_splitk": ("src/repro_torch/csrc/panel_gemm.cu",
                          "src/repro/kernels/panel_gemm.py:484"),
    "quant_panel_gemm": ("src/repro_torch/csrc/quant_gemm.cu",
                         "src/repro/quant/kernels.py:130"),
    "quant_panel_gemm_splitk": ("src/repro_torch/csrc/quant_gemm.cu",
                                "src/repro/quant/kernels.py:534"),
}
QUANT_FORMATS = ("int8", "ternary")
# The served engines: (label, quant, fuse) and the kernels each must launch.
ENGINES = [
    ("fp32", None, True, ("panel_gemm", "panel_gemm_splitk")),
    ("int8", "int8", True, ("quant_panel_gemm", "panel_gemm")),
    ("ternary", "ternary", True, ("quant_panel_gemm", "panel_gemm")),
    ("int8-unfused", "int8", False,
     ("quant_panel_gemm", "quant_panel_gemm_splitk", "panel_gemm")),
]
# NVIDIA data-sheet peaks: fp32 outside the tensor cores, HBM bandwidth.
CARD_PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60e12, 3.9e12),
              "SXM": (67e12, 3.35e12)}
PREFILL_M, DECODE_M = 128, 4
KERNEL_REPS = 20
FLUSH_BYTES = 256 << 20          # > the 50 MB L2: every launch starts cold
# Reference check: |cuda - plain| logits of the served model cut to
# REF_LAYERS layers, fp32 compute, on a REF_TOKENS prompt, relative to
# max |logit|.  Both sides sum every GEMM in fp32 in different orders
# (each within 2*K*2**-24 of the exact sum), so they differ by a few fp32
# ulps of the logits; 1e-4 leaves two orders of magnitude for that.
REF_LAYERS, REF_TOKENS = 2, 8
MODEL_REL_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", CARD_PEAKS["SXM"]


# ------------------------------------------------------------------ timing
class Timer:
    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def median_ms(self, fn, reps: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(reps):
            events.append(self._timed(fn))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def _timed(self, fn):
        self.flush.zero_()
        s = self.torch.cuda.Event(enable_timing=True)
        e = self.torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        return s, e


# ----------------------------------------------------------- kernel checks
@dataclasses.dataclass
class Case:
    name: str          # what the shape is
    kernel: str        # a key of KERNELS
    m: int
    k: int
    n: int             # packed width (both halves for glu)
    block_m: int
    block_n: int
    block_k: int
    spec: object       # EpilogueSpec or None
    split_k: int = 1
    x_dtype: str = "bfloat16"
    out_dtype: str = "bfloat16"
    real_rows: int = 0  # rows that carry data (decode pads to block_m)
    main_path: bool = True
    launches_per_step: int = 0
    fmt: str | None = None     # quantized weight format (None: fp32)


def _ds7b_packs(cfg, gemm, quant: bool):
    """deepseek-7b's packs as (name, k, parts, pack epilogue, execute
    epilogue, launches per forward step): the fp32 model's five, or the
    quantized model's four (its head stays fp32) plus the unfused model's
    ``w_gate`` (whose ``w_up`` twin has the same shape)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    glu = gemm.EpilogueSpec(glu=cfg.act)
    packs = [
        ("wqkv", d, (cfg.num_heads * cfg.head_dim,
                     cfg.num_kv_heads * cfg.head_dim,
                     cfg.num_kv_heads * cfg.head_dim), None, None,
         cfg.num_layers),
        ("wo", cfg.num_heads * cfg.head_dim, (d,), None, None,
         cfg.num_layers),
        ("w_gate_up", d, (f, f), glu, glu, cfg.num_layers),
        ("w_down", f, (d,), None, gemm.EpilogueSpec(residual=True),
         cfg.num_layers),
    ]
    if quant:
        return packs + [("w_gate(unfused)", d, (f,), None, None,
                         2 * cfg.num_layers)]
    return packs + [("lm_head", d, (v,), None, None, 1)]


def main_path_cases(cfg, gemm, packing):
    """Each pack with the blocks the model packs it with (``pack_blocks``
    at m_hint = 128 in its format, narrowed per part as ``pack_fused``
    does) and the plans the model dispatches at prefill and decode; the
    unfused ``w_gate`` only at decode, where it takes the split-K lane."""
    cases = []
    for fmt in (None,) + QUANT_FORMATS:
        for name, k, parts, pack_spec, spec, per_step in _ds7b_packs(
                cfg, gemm, fmt is not None):
            bn, bk = gemm.pack_blocks(sum(parts), k, m_hint=128,
                                      epilogue=pack_spec,
                                      weight_format=fmt or "fp32")
            bn = min(packing.fit_block(p, bn) for p in parts)
            n = sum(-(-p // bn) * bn for p in parts)
            splits = parts if len(parts) > 1 else ()
            for lane, m in (("prefill", PREFILL_M), ("decode", DECODE_M)):
                if name.endswith("(unfused)") and lane == "prefill":
                    continue
                p = gemm.plan(m, n, k, block_n=bn, block_k=bk,
                              pack=gemm.PACK_PREPACKED, epilogue=spec,
                              fused_n_splits=splits,
                              decode=lane == "decode", backend="cuda",
                              weight_format=fmt or "fp32")
                kern = ("quant_" if fmt else "") + (
                    "panel_gemm_splitk" if p.split_k > 1 else "panel_gemm")
                label = f"{name}@{lane}" + (f"/{fmt}" if fmt else "")
                cases.append(Case(
                    label, kern, p.m_pad, p.k_pad, n, p.block_m, bn, bk,
                    spec, p.split_k, real_rows=m,
                    launches_per_step=per_step, fmt=fmt))
    return cases


def variant_cases(gemm):
    """One small shape per epilogue variant, dtype pair and split, for the
    fp32 kernels and for the dequant-fused ones in each format."""
    E = gemm.EpilogueSpec
    specs = [None, E(bias=True), E(act="silu"), E(act="gelu"),
             E(act="tanh"), E(softcap=30.0), E(residual=True),
             E(bias=True, act="gelu", softcap=15.0, residual=True),
             E(glu="silu"), E(glu="gelu", bias=True, residual=True)]
    cases = []
    for fmt in (None,) + QUANT_FORMATS:
        pre = "quant_" if fmt else ""
        tag = f"/{fmt}" if fmt else ""
        for i, spec in enumerate(specs):
            glu = spec is not None and spec.glu is not None
            for xd, od in (("float32", "float32"),
                           ("bfloat16", "bfloat16")):
                cases.append(Case(f"variant{i}/{xd}{tag}", pre + "panel_gemm",
                                  64, 512, 512 if glu else 256, 64, 128, 128,
                                  spec, x_dtype=xd, out_dtype=od,
                                  real_rows=64, main_path=False, fmt=fmt))
            for s in ((2, 4) if fmt is None else (2,)):
                cases.append(Case(f"variant{i}/splitk{s}{tag}",
                                  pre + "panel_gemm_splitk", 8, 512,
                                  512 if glu else 256, 8, 128, 128, spec,
                                  split_k=s, x_dtype="float32",
                                  out_dtype="float32", real_rows=8,
                                  main_path=False, fmt=fmt))
    return cases


def run_case(torch, K, QK, F, case, timer, peaks, gen):
    def bits(t):    # compare outputs bit for bit (NaN-safe)
        t = t.contiguous()
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    spec = case.spec
    glu = spec is not None and spec.glu is not None
    n_out = case.n // 2 if glu else case.n
    split = case.kernel.endswith("_splitk")

    def rand(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dtype)

    w = rand((case.k, case.n), scale=case.k ** -0.5)
    codes = scales = None
    if case.fmt is not None:
        # per-(column, 128-row group) quantization: a fused pack's parts,
        # padded to block_n, quantize as this one weight does
        q, scales = F.quantize(w, case.fmt)
        codes = (F.pack_ternary_codes(q) if case.fmt == "ternary"
                 else q).contiguous()
        scales = scales.contiguous()
        w = F.dequantize_padded(codes, scales, case.fmt)
        del q
    x = rand((case.m, case.k), dt[case.x_dtype])
    if case.real_rows < case.m:
        x[case.real_rows:] = 0
    bias = rand((case.n,)) if spec is not None and spec.bias else None
    res = (rand((case.m, n_out)) if spec is not None and spec.residual
           else None)
    out_dtype = dt[case.out_dtype]
    kw = dict(block_n=case.block_n, block_k=case.block_k,
              out_dtype=out_dtype, epilogue=spec)
    if split:
        kw["split_k"] = case.split_k

    def fp32_kern(x_, res_, bm):
        fn = K.panel_gemm_splitk if split else K.panel_gemm
        return fn(x_, w, bias, res_, block_m=bm, **kw)

    xf = x.float()
    if case.fmt is None:
        kern = fp32_kern

        def plain(x_, res_, od):
            fn = K.panel_gemm_splitk_plain if split else K.panel_gemm_plain
            return fn(x_, w, bias, res_, block_k=case.block_k, out_dtype=od,
                      epilogue=spec, **({"split_k": case.split_k}
                                        if split else {}))

        def library():
            return torch.matmul(xf, w)
    else:
        def kern(x_, res_, bm):
            fn = QK.quant_panel_gemm_splitk if split else QK.quant_panel_gemm
            return fn(x_, codes, scales, bias, res_, weight_format=case.fmt,
                      block_m=bm, **kw)

        def plain(x_, res_, od):
            fn = (QK.quant_panel_gemm_splitk_plain if split
                  else QK.quant_panel_gemm_plain)
            return fn(x_, codes, scales, bias, res_, weight_format=case.fmt,
                      block_k=case.block_k, out_dtype=od, epilogue=spec,
                      **({"split_k": case.split_k} if split else {}))

        def library():
            return torch.matmul(
                xf, F.dequantize_padded(codes, scales, case.fmt))

    y = kern(x, res, case.block_m)
    y2 = kern(x, res, case.block_m)
    value = plain(x, res, torch.float32)
    ref = value.to(out_dtype)
    bound = K.gemm_error_bound(x, w, bias=bias, residual=res, epilogue=spec,
                               out_dtype=out_dtype, value=value)
    err = (y.float() - ref.float()).abs()
    ratio = float((err / bound).max())
    max_err = float(err.max())
    deterministic = bool(torch.equal(bits(y), bits(y2)))
    # the dequant-fused law: bit for bit the fp32 kernel on the dequantized
    # weight at the same blocks
    law = (True if case.fmt is None else
           bool(torch.equal(bits(y), bits(fp32_kern(x, res,
                                                    case.block_m)))))
    # batch invariance: the rows of an M=128 launch equal the same rows
    # launched at M=8
    x128 = rand((128, case.k), dt[case.x_dtype])
    x128[:8] = x[:8]
    r128 = None
    if res is not None:
        r128 = rand((128, n_out))
        r128[:8] = res[:8]
    y128 = kern(x128, r128, 8 if split else 128)
    y8 = kern(x128[:8].contiguous(),
              None if r128 is None else r128[:8].contiguous(), 8)
    invariant = bool(torch.equal(bits(y128[:8]), bits(y8)))
    ok = ratio <= 1.0 and deterministic and invariant and law
    line = {"kernel": case.kernel, "shape": case.name, "format": case.fmt,
            "m": case.m, "k": case.k, "n": case.n, "block_n": case.block_n,
            "block_k": case.block_k, "split_k": case.split_k,
            "epilogue": str(spec), "x_dtype": case.x_dtype,
            "out_dtype": case.out_dtype, "max_abs_err": max_err,
            "err_over_bound": ratio, "deterministic": deterministic,
            "batch_invariant": invariant, "ok": ok}
    if case.fmt is not None:
        line["bitwise_equal_fp32_kernel_on_dequantized"] = law
    if case.main_path:
        flops = 2.0 * case.m * case.n * case.k
        w_bytes = (w.numel() * 4 if case.fmt is None else
                   codes.numel() * codes.element_size() + scales.numel() * 4)
        nbytes = (x.numel() * x.element_size() + w_bytes
                  + (bias.numel() * 4 if bias is not None else 0)
                  + (res.numel() * 4 if res is not None else 0)
                  + case.m * n_out * y.element_size())
        t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
        line.update(
            kernel_ms=timer.median_ms(lambda: kern(x, res, case.block_m),
                                      KERNEL_REPS),
            plain_ms=timer.median_ms(lambda: plain(x, res, out_dtype),
                                     KERNEL_REPS),
            library_ms=timer.median_ms(library, KERNEL_REPS),
            library_call=("torch.matmul" if case.fmt is None else
                          "dequantize_padded, then torch.matmul"),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flop_bound_ms=t_ops, byte_bound_ms=t_bytes,
            launches_per_step=case.launches_per_step)
        if case.fmt is not None:
            # the product alone, on a weight dequantized beforehand
            line["matmul_on_dequantized_ms"] = timer.median_ms(
                lambda: torch.matmul(xf, w), KERNEL_REPS)
    del w, x, xf, x128, codes, scales
    return line


# ------------------------------------------------------------------- serve
def _launch_counts(K, QK):
    return {"panel_gemm": K.panel_gemm, "panel_gemm_splitk":
            K.panel_gemm_splitk, "quant_panel_gemm": QK.quant_panel_gemm,
            "quant_panel_gemm_splitk": QK.quant_panel_gemm_splitk}


def serve_engine(torch, cfg, mods, label, quant, fuse, expect, requests,
                 max_new):
    """One engine at full width and depth: load, generate per request,
    serve the same requests, then the 2-layer reference check."""
    import numpy as np
    model_zoo, transformer, gemm, ledger, Engine = (
        mods["model_zoo"], mods["transformer"], mods["gemm"],
        mods["ledger"], mods["Engine"])
    counters = _launch_counts(mods["K"], mods["QK"])
    max_len = 144                  # >= 128 + 8 - 1, a multiple of the page
    ledger.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_zoo.build(cfg, seed=0, device="cuda")
    eng = Engine(cfg, params, max_len=max_len, device="cuda", consume=True,
                 quant=quant, fuse=fuse)
    del params
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    held = torch.cuda.memory_allocated() / 2**30
    log(f"serve[{label}]: deepseek-7b built and packed in {load_s:.1f} s "
        f"({cfg.param_count() / 1e9:.2f} B params, {held:.2f} GiB on the "
        f"card)")

    # the main path: every kernel's count from 0 across generate + serve
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    gen_out, gen_stats = [], []
    for r in requests:
        toks, st = eng.generate(r[None], max_new)
        gen_out.append(toks[0].cpu().numpy())
        gen_stats.append(st)
    outs, sst = eng.serve(requests, batch_slots=2, max_new_tokens=max_new,
                          prefill_chunk=32, page_size=16,
                          check_invariants=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    for i, (o, g) in enumerate(zip(outs, gen_out)):
        if o is None or not np.array_equal(o, g):
            raise AssertionError(f"[{label}] serve != generate for request "
                                 f"{i}: {o} vs {g}")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"[{label}] {name} did not launch on the "
                                 f"main path")
    pre_tok = sum(s.prefill_tokens for s in gen_stats)
    pre_s = sum(s.prefill_s for s in gen_stats)
    dec_tok = sum(s.decode_tokens - 1 for s in gen_stats)
    dec_s = sum(s.decode_s for s in gen_stats)
    worst = max(ledger.entries(), key=lambda e: e.max_rel, default=None)
    serve = {
        "label": label, "quant": quant, "fused": fuse,
        "layers": cfg.num_layers, "requests": [len(r) for r in requests],
        "max_new_tokens": max_new, "tokens": [o.tolist() for o in outs],
        "serve_equals_generate": True, "launches": launches,
        "generate_prefill_tok_s": pre_tok / pre_s,
        "generate_decode_tok_s": dec_tok / dec_s,
        "serve_emitted_tok_s_wall": sst.total_tps,
        "serve_wall_s": sst.wall_s,
        "model_gib": held, "load_peak_gib": load_peak,
        "serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "load_s": load_s, "quant_density": sst.quant_density,
        "quant_sparse_packs": sst.quant_sparse_packs,
        "ledger_worst_max_rel": None if worst is None else worst.max_rel,
        "ledger_worst_shape": None if worst is None else [worst.k, worst.n],
        "ledger_tolerance": None if worst is None else worst.tol,
    }
    log(json.dumps({"serve": serve}))

    # a reference on a small input: the served model's first REF_LAYERS
    # layers and its head at full width, fp32 compute, through the kernels
    # and through the plain backend (which reads every weight once per
    # row, so the input is small)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                cache_dtype="float32", num_layers=REF_LAYERS)
    cut = dict(eng.params, layers=eng.params["layers"][:REF_LAYERS])
    prompt = torch.as_tensor(requests[2][None, :REF_TOKENS], device="cuda")
    logits = {}
    for backend in ("cuda", "plain"):
        with torch.no_grad(), gemm.use_backend(backend):
            logits[backend], _ = transformer.prefill(cfg32, cut, prompt,
                                                     max_len=REF_TOKENS)
    a, b = logits["cuda"], logits["plain"]
    if a.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"[{label}] bad logits {tuple(a.shape)}")
    rel = float((a - b).abs().max() / b.abs().max())
    check = {"label": label, "fp32_prefill_rel_diff_cuda_vs_plain": rel,
             "tolerance": MODEL_REL_TOL,
             "argmax_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1)))}
    log(json.dumps({"reference_check": check}))
    if rel > MODEL_REL_TOL:
        raise AssertionError(f"[{label}] fp32 logits differ by {rel:.3e} "
                             f"relative")
    del eng, cut, logits, a, b
    torch.cuda.empty_cache()
    return serve, check


def serve_phase(torch, cfg, mods, report):
    import numpy as np
    rng = np.random.default_rng(0)
    lens, max_new = (128, 77, 40, 100), 8
    requests = [rng.integers(1, cfg.vocab_size, n).astype(np.int64)
                for n in lens]
    report["serve"], report["reference_check"] = {}, {}
    launches = dict.fromkeys(KERNELS, 0)
    for label, quant, fuse, expect in ENGINES:
        serve, check = serve_engine(torch, cfg, mods, label, quant, fuse,
                                    expect, requests, max_new)
        report["serve"][label] = serve
        report["reference_check"][label] = check
        for name, n in serve["launches"].items():
            launches[name] += n
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import gemm
        from repro_torch.core import packing
        from repro_torch.kernels import cuda_lib
        from repro_torch.kernels import panel_gemm as K
        from repro_torch.models import model_zoo, transformer
        from repro_torch.quant import formats as F
        from repro_torch.quant import kernels as QK
        from repro_torch.quant import ledger
        from repro_torch.runtime.serve_loop import Engine
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    resolve_device("cuda")             # TF32 off: fp32 is IEEE fp32

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_key, peaks = card_peaks(kind)
    log(smi)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; peaks ({peak_key} data sheet): fp32 "
        f"{peaks[0] / 1e12:.1f} TFLOP/s, HBM {peaks[1] / 1e12:.2f} TB/s")
    report = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda, "peaks": peaks}

    mods = dict(cuda_lib=cuda_lib, gemm=gemm, packing=packing, K=K, QK=QK,
                F=F, model_zoo=model_zoo, transformer=transformer,
                ledger=ledger, Engine=Engine)
    try:
        summary = run_phases(torch, mods, peaks, report)
    finally:   # the report, also of a run that failed part way
        report["total_s"] = time.perf_counter() - t_start
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
                  "w") as fh:
            json.dump(report, fh, indent=1)
    log(f"total: {report['total_s']:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(torch, mods, peaks, report):
    """Build, kernels, serve; returns the per-kernel summary."""
    gemm, K, QK, F = mods["gemm"], mods["K"], mods["QK"], mods["F"]
    t0 = time.perf_counter()
    secs = mods["cuda_lib"].build()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s)")
    report["build_s"] = secs

    cfg = mods["model_zoo"].get_config("deepseek-7b")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lines = []
    for case in (main_path_cases(cfg, gemm, mods["packing"])
                 + variant_cases(gemm)):
        line = run_case(torch, K, QK, F, case, timer, peaks, gen)
        log(json.dumps(line))
        lines.append(line)
        torch.cuda.empty_cache()
    report["kernels"] = lines
    bad = [ln["shape"] + "/" + ln["kernel"] for ln in lines if not ln["ok"]]
    if bad:
        raise AssertionError(f"kernel checks failed: {bad}")
    del timer
    torch.cuda.empty_cache()

    launches = serve_phase(torch, cfg, mods, report)

    summary = []
    for name, (source, replaces) in KERNELS.items():
        mine = [ln for ln in lines if ln["kernel"] == name
                and "kernel_ms" in ln]
        t_ops = sum(ln["flop_bound_ms"] for ln in mine)
        t_bytes = sum(ln["byte_bound_ms"] for ln in mine)
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(ln["max_abs_err"] for ln in lines
                               if ln["kernel"] == name),
            "ms": sum(ln["kernel_ms"] for ln in mine),
            "plain_ms": sum(ln["plain_ms"] for ln in mine),
            "bound_ms": sum(ln["bound_ms"] for ln in mine),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(ln["library_ms"] for ln in mine),
            "library_call": mine[0]["library_call"],
            "shapes": [ln["shape"] for ln in mine],
        })
    report["summary"] = summary
    return summary


if __name__ == "__main__":
    sys.exit(main())
