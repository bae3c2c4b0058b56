#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port: builds its kernels, holds each
against its plain version, and serves Llama-3-8B through its paths.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:
  env      card name and power limit, torch/CUDA versions, kernel build time
  kernels  every kernel against its plain version at the Llama-3-8B serving
           shapes and at small shapes (window, softcap, ungated FFN, every
           activation, zero scales, K == H, Sq < Skv), in f32 and bf16;
           paged attention also at and across its split of the KV walk
           (decode lengths around one and two splits, windows below and
           above a split, T-wide chunks that cross one) and at head_dim
           256 and 192, with the bitwise T-wide and nb-bucket checks on
           every case; the bitwise repeat checks of flash attention (bf16)
           and local stats, and flash attention's bitwise batch
           invariance (each row of a B 4 call equals a B 1 call on that
           row); kernel, plain-version
           and one-library-call times (the GLASS FFN's: one compact FFN,
           three cuBLAS GEMMs, per distinct block list)
  engine   Llama-3-8B at full width (random bf16 weights from the seed)
           through the full-sequence prefill (flash-attention and
           local-stats kernels): Engine.generate on 4 prompts of 512 tokens
           in compact and block-sparse GLASS mode, and ContinuousEngine
           (compact, 2 slots) on requests of 512, 384, 200 and 37 tokens;
           launch counts (32 of each prefill kernel per prefill call); each
           request's last-prompt logits against the gather-attention chunked
           prefill, and its first token against Engine.generate alone; a
           device profile of one Engine.generate
  serve    the same model (random bf16 weights from the seed)
           through repro_torch's PagedEngine with block-sparse GLASS decode
           and the paged-attention kernel; every kernel's launch count from
           that run; the same requests again through the plain path
           (masked GLASS, gather attention) to hold the first decode tick's
           logits to a bf16 tolerance
Then the kernel summary line, the card's name and power limit as
nvidia-smi prints them, and the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 vector
# paged attention, f32: |got - ref| <= 2e-5.  bf16, elementwise:
# |got - ref| <= 8e-3 * (|ref| + A), A the same attention over |v| (the sum
# of p_i |v_i| / l).  The kernel rounds each probability to bf16 against a
# running max, the plain version against the final max (up to 2^-8 of the
# term each), and each rounds its output once (up to 2^-8 of the value), so
# 2^-7 * (|ref| + A) bounds a correct kernel; 8e-3 leaves 2% for f32
# reordering.  tests/test_torch_kernels.py holds the JAX kernel (whose
# online softmax rounds as this kernel does) within it, and shows that one
# wrong 16-key block of a 543-key row exceeds it.
PA_F32_ATOL, PA_BF16_RTOL = 2e-5, 8e-3
FFN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # GLASS FFN, relative to max |ref|
# serve: ||a - b|| / ||b|| of each request's first-decode logits, kernel path
# against the plain path, bf16 over 32 layers.  The two paths round
# attention differently (the kernel rounds unnormalized probabilities to
# bf16, the gather path normalized ones, as the JAX package's two paths
# do).  Correct runs read 0.027-0.035 for every request (NVIDIA H100 80GB
# HBM3, 700 W); unrelated logits read about 1.4.
LOGITS_REL_TOL = {"median": 0.05, "max": 0.1}
# flash attention: the paged-attention limits (the same two roundings of
# each probability term, the same output rounding)
FA_F32_ATOL, FA_BF16_RTOL = PA_F32_ATOL, PA_BF16_RTOL
# local stats: |got - ref| <= 1e-5 * |ref| + 1e-6.  Both read the same
# values in f32 and differ only in summation order (T terms of at most 1)
LS_RTOL, LS_ATOL = 1e-5, 1e-6
# engine: ||a - b|| / ||b|| of each request's last-prompt-position logits,
# flash-attention prefill against the gather-attention chunked prefill,
# bf16 over 32 layers: the two round attention differently, as the decode
# paths of the serve phase do.  Correct runs read 0.0154-0.0164 for the
# four requests (NVIDIA H100 80GB HBM3, 700 W); unrelated logits read
# about 1.4.
PREFILL_LOGITS_REL_TOL = {"median": 0.03, "max": 0.05}

KERNELS = {
    "paged_attention": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:125",
    ),
    "glass_ffn": dict(
        source="src/repro_torch/csrc/glass_ffn.cu",
        replaces="src/repro/kernels/glass_ffn.py:82",
    ),
    "glass_ffn_rowwise": dict(
        source="src/repro_torch/csrc/glass_ffn.cu",
        replaces="src/repro/kernels/glass_ffn.py:161",
    ),
    "local_stats": dict(
        source="src/repro_torch/csrc/local_stats.cu",
        replaces="src/repro/kernels/local_stats.py:51",
    ),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97",
    ),
}
SERVE_KERNELS = ("paged_attention", "glass_ffn", "glass_ffn_rowwise")  # PagedEngine decode
PREFILL_KERNELS = ("flash_attention", "local_stats")  # Model.prefill


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Milliseconds per call from CUDA events over many calls.  ``cold``
    flushes the 50 MB L2 between calls (and subtracts the flush's own
    time), as a decode tick finds a layer's KV after 31 other layers."""

    def __init__(self, device):
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)

    def _run(self, fn, iters, flush):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            if flush:
                self.flush_buf.zero_()
            if fn is not None:
                fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def ms(self, fn, iters=50, cold=False) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t = self._run(fn, iters, cold)
        if cold:
            t -= self._run(None, iters, True)
        return t


# -- kernels ------------------------------------------------------------------


def _paged_err(got, ref, args, window, softcap=None):
    """(max |got - ref|, its largest ratio to the elementwise limit); the
    check passes when the ratio is at most 1."""
    from repro_torch.kernels.ref import paged_attention_ref

    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        lim = torch.full_like(err, PA_F32_ATOL)
    else:
        q, ck, cv, tab, clen = args
        a = paged_attention_ref(q.float(), ck.float(), cv.float().abs(), tab, clen, window,
                                softcap=softcap)
        lim = PA_BF16_RTOL * (ref.float().abs() + a)
    return err.max().item(), (err / lim).max().item()


def _pool_case(gen, dev, dtype, *, B, T, K, G, hd, bs, num_blocks, lens, nb):
    """A pool full of random rows (stale rows past each frontier included),
    disjoint random block lists per row, and queries at ``lens``."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    cache_k, cache_v = randn(num_blocks, bs, K, hd), randn(num_blocks, bs, K, hd)
    perm = torch.randperm(num_blocks - 1, generator=gen, device=dev) + 1
    table = torch.zeros(B, nb, dtype=torch.int32, device=dev)
    off = 0
    for b, n in enumerate(lens):
        if n == 0:  # an inactive decode row: trash block 0, as the engine feeds it
            continue
        need = -(-(n + T) // bs)
        table[b, :need] = perm[off : off + need].to(torch.int32)
        off += need
    cache_len = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    return randn(B, T, K, G, hd), cache_k, cache_v, table, cache_len


def _paged_bound(q, table, cache_len, bs, dtype):
    """Least time for the call: live KV blocks + q + out over the HBM rate,
    or QK and PV flops over the peak rate, whichever is larger."""
    B, T, K, G, hd = q.shape
    el = q.element_size()
    blocks = sum(min((int(cache_len[b]) + T - 1) // bs + 1, table.shape[1]) for b in range(B))
    nbytes = blocks * K * 2 * bs * hd * el + 2 * q.numel() * el + table.numel() * 4
    keys = sum(int(cache_len[b]) * T + T * (T + 1) // 2 for b in range(B))
    flops = 4 * keys * K * G * hd
    return _bound(nbytes, flops, dtype)


def _bound(nbytes, flops, dtype):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _ffn_bound(x, block_idx, block_scale, bs, rowwise):
    d = x.shape[1]
    el = x.element_size()
    idx, sc = block_idx.reshape(-1, block_idx.shape[-1]), block_scale.reshape(-1, block_idx.shape[-1])
    live = sc != 0
    tiles = int(torch.unique(idx[live]).numel())
    row_tiles = int(live.sum()) * (1 if rowwise else x.shape[0])
    nbytes = tiles * 3 * d * bs * el + x.numel() * el + x.shape[0] * d * 4
    flops = row_tiles * 6 * d * bs
    return _bound(nbytes, flops, x.dtype)


def _compact_ffn_ms(timer, cfg, x, wu, wd, wg, idx, sc, bs):
    """The yardstick for the GLASS FFN: ``ffn_forward`` over compact
    weights (the list's units gathered beforehand, three cuBLAS GEMMs),
    once for the rows of a shared list, or once per distinct list of the
    live rows with one row each (the rowwise kernel's rows)."""
    from repro_torch.models.ffn import compact_ffn_params, ffn_forward

    dense = {"w_up": wu, "w_gate": wg, "w_down": wd}
    lists = idx[None] if idx.ndim == 1 else idx
    live = [r for r in range(lists.shape[0]) if bool((sc.reshape(lists.shape)[r] != 0).any())]
    calls = []
    for r in live:
        units = (lists[r].long()[:, None] * bs + torch.arange(bs, device=x.device)).reshape(-1)
        calls.append((compact_ffn_params(dense, units), x if idx.ndim == 1 else x[r : r + 1]))

    def run():
        for p, xr in calls:
            ffn_forward(p, xr, cfg)

    return timer.ms(run)


def _paged_bitwise(got, args, window, softcap):
    """The bitwise contracts of paged attention on one case: a T-wide call
    equals T one-query calls, and a table four times as wide and one of at
    least 64 entries (trash entries past every frontier) change no bit.
    Returns {check: bool}."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    q, ck, cv, tab, clen = args
    out = {}
    if q.shape[1] > 1:
        singles = torch.cat([
            paged_attention_cuda(q[:, t : t + 1].contiguous(), ck, cv, tab, clen + t, window,
                                 softcap=softcap)
            for t in range(q.shape[1])
        ], dim=1)
        out["t_wide_bitwise"] = bool(torch.equal(singles, got))
    for nb in sorted({4 * tab.shape[1], max(64, tab.shape[1])}):
        wide = torch.zeros(tab.shape[0], nb, dtype=torch.int32, device=tab.device)
        wide[:, : tab.shape[1]] = tab
        out[f"bucket_{nb}_bitwise"] = bool(torch.equal(
            paged_attention_cuda(q, ck, cv, wide, clen, window, softcap=softcap), got))
    return out


def paged_attention_checks(timer, gen, dev, summary, report):
    """Paged attention against its plain version: small shapes (window,
    softcap, trash rows, T > 1, a G that does not divide 16, a block size
    that does not divide the split, a head_dim padded to the tensor-core
    tile and one the tensor cores do not take, head_dim 256 and 192), the
    serving shapes, and
    cases that straddle the kernel's split of the KV walk; every case in
    f32 and bf16 with the T-wide and nb-bucket bitwise checks.  Times the
    serving shapes (both launches)."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda, split_size
    from repro_torch.kernels.ref import paged_attention_ref

    S = split_size()
    serve_heads = dict(K=8, G=4, hd=128, bs=16, num_blocks=289)
    cases = [  # (label, shape kwargs, window, softcap)
        *[("small", dict(B=3, T=5, K=2, G=3, hd=64, bs=8, num_blocks=12, lens=[0, 9, 17], nb=4),
           w, c) for w, c in ((2**30, None), (6, None), (2**30, 30.0), (3, 12.0))],
        ("odd_shape", dict(B=3, T=3, K=1, G=5, hd=80, bs=12, num_blocks=60, lens=[0, 125, 250],
                           nb=24), 40, None),
        ("odd_shape", dict(B=2, T=4, K=2, G=2, hd=36, bs=8, num_blocks=80, lens=[130, 7],
                           nb=20), 2**30, 20.0),
        # head_dim 256, and 192 padded to it: the tensor-core path that reads
        # Q from shared memory at every k-step; queries cross a split
        ("head_dim_256", dict(B=3, T=5, K=2, G=3, hd=256, bs=8, num_blocks=80,
                              lens=[0, S - 2, 2 * S + 3], nb=36), 2**30, None),
        ("head_dim_256", dict(B=3, T=5, K=2, G=3, hd=192, bs=8, num_blocks=80,
                              lens=[0, S - 2, 2 * S + 3], nb=36), 100, 20.0),
        # decode rows at split - 2 .. 2 * split + 1, and one inactive row
        ("split_edges", dict(B=8, T=1, lens=[S - 2, S - 1, S, S + 1, 2 * S - 1, 2 * S, 2 * S + 1,
                                             0], nb=20, **serve_heads), 2**30, None),
        # windows below a split and above it, each crossing a split boundary
        ("window_split", dict(B=8, T=1, lens=[S - 1, S, S + 30, 3 * S + 7, 60, 10, 0, 2 * S],
                              nb=28, **serve_heads), 50, None),
        ("window_split", dict(B=4, T=1, lens=[S + 30, 3 * S + 7, 2 * S + 99, 250], nb=28,
                              **serve_heads), 200, 30.0),
        # T-wide chunks whose queries cross a split boundary
        ("chunk_split", dict(B=2, T=64, lens=[S - 28, 2 * S - 56], nb=20, **serve_heads), 2**30,
         None),
        ("chunk_split", dict(B=2, T=64, lens=[S - 28, 2 * S - 56], nb=20, **serve_heads), 50,
         30.0),
    ]
    # the serving shapes: decode (B=8, T=1) and one prefill chunk (B=1, T=128)
    serving = {
        "decode": dict(B=8, T=1, lens=[543, 511, 383, 255, 199, 127, 0, 0], nb=36),
        "prefill": dict(B=1, T=128, lens=[256], nb=32),
    }
    cases += [(label, dict(sh, **serve_heads), 2**30, None) for label, sh in serving.items()]
    for dtype in (torch.float32, torch.bfloat16):
        for label, sh, window, softcap in cases:
            args = _pool_case(gen, dev, dtype, **sh)
            got = paged_attention_cuda(*args, window, softcap=softcap)
            ref = paged_attention_ref(*args, window, softcap=softcap)
            err, over = _paged_err(got, ref, args, window, softcap)
            what = f"paged_attention {label} {dtype} {sh} window={window} softcap={softcap}"
            check(bool(torch.isfinite(got).all()) and over <= 1.0,
                  f"{what}: err {err}, {over} of the limit")
            row = dict(kernel="paged_attention", dtype=str(dtype), shape=label,
                       **{k: sh[k] for k in ("B", "T", "K", "G", "hd", "bs", "lens")},
                       window=window, softcap=softcap, max_abs_err=err, err_over_limit=over)
            bitwise = _paged_bitwise(got, args, window, softcap)
            row.update(bitwise)
            check(all(bitwise.values()), f"{what}: a bitwise contract fails: {bitwise}")
            if label in serving and dtype is torch.bfloat16:
                q, ck, cv, tab, clen = args
                kernel = lambda: paged_attention_cuda(*args, 2**30)
                row["ms"] = timer.ms(kernel, cold=True)
                row["device_ms"] = _device_ms(kernel)
                row["plain_ms"] = timer.ms(lambda: paged_attention_ref(*args, 2**30), iters=5)
                row["bound_ms"], row["bound_by"] = _paged_bound(q, tab, clen, 16, dtype)
                row["library_ms"], row["library_device_ms"] = _sdpa_ms(timer, *args)
                if label == "decode":
                    summary["paged_attention"] = dict(
                        max_abs_err=err, **{k: row[k] for k in
                                            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
            report["checks"].append(row)


def kernels_phase(timer):
    from repro_torch.configs import get_config
    from repro_torch.kernels.glass_ffn import glass_ffn_cuda, glass_ffn_rowwise_cuda
    from repro_torch.kernels.ref import glass_ffn_ref, glass_ffn_rowwise_ref

    dev = torch.device("cuda")
    # one generator per kernel family, so that cases added to one family
    # leave the other families' inputs (and times) as they were
    seeded = lambda k: torch.Generator(device=dev).manual_seed(SEED + k)
    summary = {name: {} for name in KERNELS}
    report = {"phase": "kernels", "checks": []}
    paged_attention_checks(timer, seeded(0), dev, summary, report)
    gen = seeded(1)

    # -- GLASS FFN: small shapes (every activation, ungated, zero scales, > 8 rows)
    def ffn_case(dtype, B, d, m, bs, nbk, gated, rowwise, zero_scales):
        s = d ** -0.5
        x = torch.randn(B, d, generator=gen, device=dev).to(dtype)
        wu = (torch.randn(d, m, generator=gen, device=dev) * s).to(dtype)
        wg = (torch.randn(d, m, generator=gen, device=dev) * s).to(dtype) if gated else None
        wd = (torch.randn(m, d, generator=gen, device=dev) * (m ** -0.5)).to(dtype)
        rows = B if rowwise else 1
        idx = torch.stack([torch.sort(torch.randperm(m // bs, generator=gen, device=dev)[:nbk]).values
                           for _ in range(rows)]).to(torch.int32)
        sc = torch.ones(rows, nbk, device=dev)
        if zero_scales:
            sc[:, ::3] = 0.0
        if not rowwise:
            idx, sc = idx[0], sc[0]
        return x, wu, wd, idx, wg, sc

    for dtype in (torch.float32, torch.bfloat16):
        for act in ("silu", "gelu", "relu", "relu2"):
            for gated, rowwise, zero_scales, B in ((True, False, False, 9), (False, True, True, 3),
                                                   (True, True, False, 5), (False, False, True, 2)):
                x, wu, wd, idx, wg, sc = ffn_case(dtype, B, 256, 1024, 128, 4, gated, rowwise,
                                                  zero_scales)
                kern = glass_ffn_rowwise_cuda if rowwise else glass_ffn_cuda
                ref_fn = glass_ffn_rowwise_ref if rowwise else glass_ffn_ref
                for scale in (sc, None):
                    got = kern(x, wu, wd, idx, wg, block_scale=scale, act=act)
                    ref = ref_fn(x, wu, wd, idx, wg, block_scale=scale, act=act)
                    err = (got - ref).abs().max().item()
                    lim = FFN_TOL[dtype] * max(1.0, ref.abs().max().item())
                    report["checks"].append(dict(
                        kernel=kern.__name__.removesuffix("_cuda"), dtype=str(dtype), act=act,
                        gated=gated, B=B, scaled=scale is not None, zero_scales=zero_scales,
                        max_abs_err=err))
                    check(err <= lim, f"{kern.__name__} small {dtype} {act} gated={gated}: {err}")

    # -- GLASS FFN at the serving shapes: d 4096, m 14336, block 128, 56 blocks
    # kept at density 0.5; the shared list serves 2 rows, the rowwise kernel
    # 4 distinct lists plus 2 inactive rows (block 0, scale 0)
    ffn_cfg = get_config("llama3-8b")  # silu, gated
    for dtype in (torch.float32, torch.bfloat16):
        for rowwise, B in ((False, 2), (True, 6)):
            x, wu, wd, idx, wg, sc = ffn_case(dtype, B, 4096, 14336, 128, 56, True, rowwise, False)
            if rowwise:
                idx[4:] = 0
                sc[4:] = 0.0
            kern = glass_ffn_rowwise_cuda if rowwise else glass_ffn_cuda
            ref_fn = glass_ffn_rowwise_ref if rowwise else glass_ffn_ref
            got = kern(x, wu, wd, idx, wg, block_scale=sc)
            ref = ref_fn(x, wu, wd, idx, wg, block_scale=sc)
            err = (got - ref).abs().max().item()
            check(err <= FFN_TOL[dtype] * max(1.0, ref.abs().max().item()),
                  f"{kern.__name__} serving shape {dtype}: err {err}")
            name = "glass_ffn_rowwise" if rowwise else "glass_ffn"
            row = dict(kernel=name, dtype=str(dtype), shape="serving", B=B, max_abs_err=err)
            if dtype is torch.bfloat16:
                row["ms"] = timer.ms(lambda: kern(x, wu, wd, idx, wg, block_scale=sc))
                row["plain_ms"] = timer.ms(lambda: ref_fn(x, wu, wd, idx, wg, block_scale=sc),
                                           iters=3)
                row["bound_ms"], row["bound_by"] = _ffn_bound(x, idx, sc, 128, rowwise)
                row["library_ms"] = _compact_ffn_ms(timer, ffn_cfg, x, wu, wd, wg, idx, sc, 128)
                summary[name] = dict(max_abs_err=err, **{k: row[k] for k in
                                                         ("ms", "plain_ms", "bound_ms", "bound_by",
                                                          "library_ms")})
            report["checks"].append(row)
        del x, wu, wd, wg
    prefill_kernel_checks(timer, seeded(2), dev, summary, report)
    emit(report)
    return summary


def _flash_err(got, q, k, v, window, softcap):
    """(max |got - ref|, its largest ratio to the elementwise limit)."""
    from repro_torch.kernels.ref import flash_attention_ref

    ref = flash_attention_ref(q, k, v, window=window, softcap=softcap)
    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        lim = torch.full_like(err, FA_F32_ATOL)
    else:
        a = flash_attention_ref(q.float(), k.float(), v.float().abs(), window=window,
                                softcap=softcap)
        lim = FA_BF16_RTOL * (ref.float().abs() + a)
    return err.max().item(), (err / lim).max().item()


def _flash_bound(q, k, window, dtype):
    """Least time for a causal call: q, k, v, out once over the HBM rate,
    or 4 * hd flops per attended (query, key) pair over the peak rate."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    el = q.element_size()
    nbytes = 2 * B * H * Sq * hd * el + 2 * B * K * Skv * hd * el
    qpos = np.arange(Sq) + (Skv - Sq)
    lo = np.maximum(qpos - (window if window is not None else 2**30) + 1, 0)
    pairs = int(np.sum(qpos + 1 - lo))
    return _bound(nbytes, 4 * B * H * pairs * hd, dtype)


def _device_ms(fn, iters=20) -> float:
    """Device time of one call of ``fn`` (every kernel it launches), from
    torch.profiler over ``iters`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / iters / 1e3


def prefill_kernel_checks(timer, gen, dev, summary, report):
    """Flash attention and local stats against their plain versions."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.local_stats import local_stats_cuda
    from repro_torch.kernels.ref import flash_attention_ref, local_stats_ref

    def model_layout(dtype, B, H, K, Sq, Skv, hd):
        """q, k, v as the model hands them over: (B, S, heads, hd) buffers
        viewed as (B, heads, S, hd)."""
        q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype).transpose(1, 2)
        k, v = (torch.randn(B, Skv, K, hd, generator=gen, device=dev).to(dtype).transpose(1, 2)
                for _ in range(2))
        return q, k, v

    # small shapes: window 32, softcap 30, Sq < Skv, K == H, every head_dim
    small = [(2, 6, 2, 50, 77, 64, 32, None), (2, 4, 4, 70, 70, 64, None, 30.0),
             (1, 8, 8, 100, 160, 128, 32, 30.0), (1, 2, 2, 33, 40, 256, 5, 12.0)]
    serving = [(B, 32, 8, S, S, 128, None, None) for B in (1, 4) for S in (512, 200, 37)]
    for dtype in (torch.float32, torch.bfloat16):
        for label, cases in (("small", small), ("serving", serving)):
            for B, H, K, Sq, Skv, hd, window, softcap in cases:
                q, k, v = model_layout(dtype, B, H, K, Sq, Skv, hd)
                got = flash_attention_cuda(q, k, v, window=window, softcap=softcap)
                err, over = _flash_err(got, q, k, v, window, softcap)
                check(bool(torch.isfinite(got).all()) and over <= 1.0,
                      f"flash_attention {label} {dtype} B={B} H={H} K={K} Sq={Sq} Skv={Skv} "
                      f"hd={hd} window={window} softcap={softcap}: err {err}, {over} of the limit")
                row = dict(kernel="flash_attention", dtype=str(dtype), shape=label, B=B, H=H, K=K,
                           Sq=Sq, Skv=Skv, hd=hd, window=window, softcap=softcap,
                           max_abs_err=err, err_over_limit=over)
                if dtype is torch.bfloat16:  # bitwise: deterministic and batch-invariant
                    again = flash_attention_cuda(q, k, v, window=window, softcap=softcap)
                    row["repeat_bitwise"] = bool(torch.equal(again, got))
                    check(row["repeat_bitwise"], f"flash_attention {label} B={B} Sq={Sq} hd={hd}: "
                          "two calls differ bitwise")
                    if B > 1:
                        row["batch_invariant_bitwise"] = all(
                            torch.equal(flash_attention_cuda(q[i : i + 1], k[i : i + 1],
                                                             v[i : i + 1], window=window,
                                                             softcap=softcap), got[i : i + 1])
                            for i in range(B))
                        check(row["batch_invariant_bitwise"],
                              f"flash_attention {label} B={B} Sq={Sq} hd={hd}: a batch row "
                              "differs bitwise from a B 1 call on it")
                if label == "serving" and dtype is torch.bfloat16:
                    kernel = lambda: flash_attention_cuda(q, k, v)
                    row["ms"] = timer.ms(kernel)
                    row["plain_ms"] = timer.ms(lambda: flash_attention_ref(q, k, v), iters=3)
                    row["bound_ms"], row["bound_by"] = _flash_bound(q, k, None, dtype)
                    qc, kc, vc = (t.contiguous() for t in (q, k, v))
                    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                        qc, kc, vc, is_causal=True, enable_gqa=True)
                    row["library_ms"] = timer.ms(sdpa)
                    # the same two calls' device time alone: where "ms" exceeds it,
                    # the host's enqueue of back-to-back calls bounds the loop
                    row["device_ms"] = _device_ms(kernel)
                    row["library_device_ms"] = _device_ms(sdpa)
                    if (B, Sq) == (4, 512):  # Engine.generate's prefill
                        summary["flash_attention"] = dict(max_abs_err=err, **{
                            k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")})
                report["checks"].append(row)

    # local stats: the serving shapes of one prefill call (1 x 128 chunk,
    # 4 x 512, 1 x 200 tokens by d_ff 14336), with and without a row mask
    for dtype in (torch.float32, torch.bfloat16):
        for T in (128, 2048, 200):
            h = (torch.randn(T, 14336, generator=gen, device=dev) * 0.5).to(dtype)
            mask = (torch.rand(T, generator=gen, device=dev) > 0.3).float()
            for row_mask in (None, mask):
                got = local_stats_cuda(h, row_mask)
                ref = local_stats_ref(h, row_mask)
                err = (got - ref).abs()
                over = (err / (LS_RTOL * ref.abs() + LS_ATOL)).max().item()
                repeat = bool(torch.equal(got, local_stats_cuda(h, row_mask)))
                check(bool(torch.isfinite(got).all()) and over <= 1.0,
                      f"local_stats {dtype} T={T} mask={row_mask is not None}: {over} of the limit")
                check(repeat, f"local_stats {dtype} T={T}: two calls differ bitwise")
                row = dict(kernel="local_stats", dtype=str(dtype), T=T, m=14336,
                           row_mask=row_mask is not None, max_abs_err=err.max().item(),
                           err_over_limit=over, repeat_bitwise=repeat)
                if dtype is torch.bfloat16 and row_mask is None:
                    row["ms"] = timer.ms(lambda: local_stats_cuda(h))
                    row["plain_ms"] = timer.ms(lambda: local_stats_ref(h), iters=5)
                    # h read once, out written once; ~4 f32 operations an element
                    row["bound_ms"], row["bound_by"] = _bound(h.numel() * h.element_size()
                                                              + 14336 * 4, 4 * h.numel(),
                                                              torch.float32)
                    row["library_ms"] = None  # no single PyTorch call computes it
                    if T == 2048:  # Engine.generate's prefill
                        summary["local_stats"] = dict(max_abs_err=row["max_abs_err"], **{
                            k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")})
                report["checks"].append(row)


def _sdpa_ms(timer, q, ck, cv, tab, clen):
    """The yardstick for paged attention: one scaled_dot_product_attention
    call over the rows' KV, gathered beforehand, with the same mask.
    Returns (ms with the L2 flushed, profiler device ms)."""
    B, T, K, G, hd = q.shape
    bs, nb = ck.shape[1], tab.shape[1]
    kg = ck[tab.long()].reshape(B, nb * bs, K, hd)
    vg = cv[tab.long()].reshape(B, nb * bs, K, hd)
    kh = kg.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)  # (B, H, N, hd)
    vh = vg.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    qh = q.reshape(B, T, K * G, hd).permute(0, 2, 1, 3)
    qpos = clen.long()[:, None] + torch.arange(T, device=q.device)
    mask = (qpos[:, :, None] >= torch.arange(nb * bs, device=q.device))[:, None]
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    return timer.ms(fn, cold=True), _device_ms(fn)


# -- serve ----------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _serve(model, params, prior, prompts, max_new, glass, device="cuda", *, max_len=544,
           chunk_tokens=128, **eng_kw):
    from repro_torch.serve import PagedEngine

    eng = PagedEngine(model, params, max_slots=8, max_len=max_len, block_size=16,
                      chunk_tokens=chunk_tokens, glass=glass, global_prior=prior,
                      alloc_mode="full", device=device, **eng_kw)
    for i, p in enumerate(prompts):
        eng.add_request(p, max_new, uid=i)
    first_logits, done = {}, {}
    times = {"prefill": [0.0, 0], "decode": [0.0, 0], "mixed": [0.0, 0]}
    t_all = time.perf_counter()
    while len(eng.scheduler) or eng.pool.active.any():
        p0, d0 = eng.prefill_tokens, eng.slot_steps
        _sync(device)
        t0 = time.perf_counter()
        for out in eng.step():
            if out.finished:
                done[out.uid] = out
        _sync(device)
        dt = time.perf_counter() - t0
        dp, dd = eng.prefill_tokens - p0, eng.slot_steps - d0
        kind = "prefill" if dp and not dd else "decode" if dd and not dp else "mixed"
        times[kind][0] += dt
        times[kind][1] += dp + dd
        for uid, lg in eng.first_logits.items():
            first_logits[uid] = lg.clone()
        check(eng.t < 10_000, "engine did not drain")
    wall = time.perf_counter() - t_all
    return eng, done, first_logits, times, wall


def _device_profile(run):
    """Device time by kernel over ``run()`` (torch.profiler, CUDA
    activity): per-group and top-kernel sums, the number of device calls,
    and the busy share of the profiled wall time (a lower bound: the
    profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"paged_attention": ("paged_attention_",),
              "glass_ffn_hidden": ("hidden_kernel",), "glass_ffn_down": ("down_kernel",),
              "flash_attention": ("flash_attention_kernel", "flash_attention_mma_kernel"),
              "local_stats": ("row_norm_kernel", "col_partial_kernel", "col_final_kernel")}
    by_group, kernels, calls = {}, [], 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        calls += evt.count
        ms = evt.self_device_time_total / 1e3
        name = evt.key
        group = next((g for g, tags in groups.items() if any(t in name for t in tags)), None)
        if group is None:
            gemm = any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
            group = "cublas_gemm" if gemm else "other"
        by_group[group] = by_group.get(group, 0.0) + ms
        kernels.append((ms, evt.count, name[:90]))
    total = sum(by_group.values())
    kernels.sort(reverse=True)
    return {"wall_s": wall, "device_ms": total, "device_busy_share": total / 1e3 / wall,
            "device_calls": calls, "device_ms_by_group": by_group,
            "top_kernels": [dict(ms=k[0], calls=k[1], name=k[2]) for k in kernels[:10]]}


def llama_setup():
    """Llama-3-8B at full width and depth, random bf16 weights and a random
    prior from the seed, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("llama3-8b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prior = torch.rand(cfg.n_layers, cfg.d_ff, generator=gen, device="cuda")
    return cfg, model, params, prior, init_s


def _counted(fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; returns (its result, seconds, launch counts)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ops.launch_counts()


def engine_phase(cfg, model, params, prior):
    """The full-sequence prefill path: Engine and ContinuousEngine."""
    from repro_torch.core import GlassConfig
    from repro_torch.serve import ContinuousEngine, Engine, Request

    L, V = cfg.n_layers, cfg.vocab_size
    rs = np.random.RandomState(SEED + 2)
    max_new = 32
    batch = rs.randint(0, V, size=(4, 512)).astype(np.int32)
    lens = [512, 384, 200, 37]
    prompts = [rs.randint(0, V, n).astype(np.int32) for n in lens]
    compact = dict(glass=GlassConfig(density=0.5), global_prior=prior, glass_mode="compact")
    block = dict(glass=GlassConfig(density=0.5, selection="block", block_size=128),
                 global_prior=prior, glass_mode="block_sparse")
    report = {"phase": "engine", "model": cfg.name, "n_layers": L, "d_model": cfg.d_model,
              "batch": list(batch.shape), "max_new": max_new, "continuous_prompt_lens": lens}
    launches = dict.fromkeys(PREFILL_KERNELS, 0)

    def expect(counts, what, prefills, **extra):
        """Exactly one launch of each prefill kernel per layer per prefill
        call, and what ``extra`` names; nothing else."""
        want = {k: 0 for k in counts}
        want.update(flash_attention=L * prefills, local_stats=L * prefills, **extra)
        check(counts == want, f"{what}: launches {counts}, expected {want}")
        for k in PREFILL_KERNELS:
            launches[k] += counts[k]

    Engine(model, params, **compact).generate(batch[:1, :64], 2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    toks = torch.as_tensor(batch, dtype=torch.int64, device="cuda")
    _, t_pre, n = _counted(lambda: model.prefill(params, {"tokens": toks}, 512 + max_new))
    expect(n, "Model.prefill", 1)
    report["prefill_tok_s"] = batch.size / t_pre
    for name, kw in (("compact", compact), ("block_sparse", block)):
        eng = Engine(model, params, **kw)
        first, t1, n1 = _counted(lambda: eng.generate(batch, 1))
        expect(n1, f"Engine {name} max_new=1", 1)
        res, t, n = _counted(lambda: eng.generate(batch, max_new))
        rows_ffn = {"glass_ffn": L * (max_new - 1)} if name == "block_sparse" else {}
        expect(n, f"Engine {name}", 1, **rows_ffn)
        in_vocab = bool(((res.tokens >= 0) & (res.tokens < V)).all())
        check(res.tokens.shape == (4, max_new) and in_vocab, f"Engine {name}: tokens {res.tokens}")
        check(np.array_equal(first.tokens[:, 0], res.tokens[:, 0]),
              f"Engine {name}: the first token depends on max_new")
        report[f"engine_{name}"] = dict(
            wall_s=t, launches=n, generate_max_new_1_s=t1,
            decode_tok_s=batch.shape[0] * (max_new - 1) / (t - t1))
        del eng

    ceng = ContinuousEngine(model, params, max_slots=2, max_len=512 + max_new, **compact)
    for i, p in enumerate(prompts):
        ceng.submit(Request(uid=i, prompt=p, max_new=max_new))

    def drain():
        done, times = {}, {"admit": [0.0, 0], "decode": [0.0, 0]}
        while ceng._work_remaining():
            queued, steps0 = len(ceng.scheduler), ceng.slot_steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in ceng.step():
                done[f.uid] = f
            torch.cuda.synchronize()
            kind = "admit" if len(ceng.scheduler) < queued else "decode"
            times[kind][0] += time.perf_counter() - t0
            times[kind][1] += ceng.slot_steps - steps0
            check(ceng.t < 10_000, "ContinuousEngine did not drain")
        return done, times

    (done, times), t_c, n = _counted(drain)
    expect(n, "ContinuousEngine", len(prompts))
    check(sorted(done) == list(range(len(prompts))), f"not every request finished: {sorted(done)}")
    check(all(len(done[u].tokens) == max_new for u in done), "a request stopped short")
    check(ceng.pool.n_free == 2 and not ceng.pool.active.any(), "slots still held after the drain")
    report["continuous"] = dict(wall_s=t_c, launches=n, t=ceng.t, slot_steps=ceng.slot_steps,
                                decode_tok_s=times["decode"][1] / max(times["decode"][0], 1e-9),
                                step_seconds={k: v[0] for k, v in times.items()},
                                step_tokens={k: v[1] for k, v in times.items()})
    del ceng
    report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()

    # each request alone: Engine.generate's first token, and the kernel
    # path's last-prompt logits against the gather-attention chunked prefill
    ref_eng = Engine(model, params, **compact)
    rel, argmax_equal, first_equal, prefill_s = {}, {}, {}, {}
    for i, p in enumerate(prompts):
        alone = ref_eng.generate(p[None], 1).tokens[0, 0]
        first_equal[i] = bool(alone == done[i].tokens[0])
        tk = torch.as_tensor(p, dtype=torch.int64, device="cuda")[None]
        (lg, _, _), prefill_s[i], _ = _counted(
            lambda: model.prefill(params, {"tokens": tk}, len(p)))
        nb = -(-len(p) // 16)
        shape = (L, nb + 1, 16, cfg.n_kv_heads, cfg.head_dim)
        cache = {k: torch.zeros(shape, dtype=cfg.compute_dtype, device="cuda") for k in "kv"}
        tab = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")[None]
        ref, _, _ = model.prefill_chunk(params, tk, cache, torch.zeros(1, dtype=torch.int32,
                                                                        device="cuda"),
                                        block_table=tab, attn_mode="gather")
        a, b = lg[0, -1].float(), ref[0, -1].float()
        rel[i] = ((a - b).norm() / b.norm()).item()
        argmax_equal[i] = bool(a.argmax() == b.argmax())
        del cache, ref, lg
    report.update(first_token_equals_engine_alone=first_equal,
                  last_prompt_logits_rel_l2=rel, prefill_logits_rel_tol=PREFILL_LOGITS_REL_TOL,
                  last_prompt_argmax_equal=argmax_equal,
                  prefill_alone_tok_s={lens[i]: lens[i] / t for i, t in prefill_s.items()})
    report["profile"] = _device_profile(
        lambda: Engine(model, params, **compact).generate(batch, max_new))
    report["card"] = nvidia_smi_line()
    emit(report)
    check(all(first_equal.values()),
          f"ContinuousEngine first tokens != Engine alone: {first_equal}")
    rels = sorted(rel.values())
    check(float(np.median(rels)) <= PREFILL_LOGITS_REL_TOL["median"]
          and rels[-1] <= PREFILL_LOGITS_REL_TOL["max"],
          f"last-prompt logits differ from the gather path beyond {PREFILL_LOGITS_REL_TOL}: {rel}")
    return launches


def serve_phase(cfg, model, params, prior, init_s):
    from repro_torch.core import GlassConfig
    from repro_torch.kernels import ops

    rs = np.random.RandomState(SEED)
    lens = [512, 512, 384, 256, 200, 128]
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    prompts[1] = prompts[0]  # two requests share one prompt -> one block list
    max_new = 32
    glass = GlassConfig(density=0.5, selection="block", block_size=128)
    fast = dict(glass_mode="block_sparse", attn_mode="paged_pallas")
    # warm-up (library handles, lazy loads) so that the timed run is steady
    _serve(model, params, prior, [prompts[5][:64]], 4, glass, **fast)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    eng, done, first, times, wall = _serve(model, params, prior, prompts, max_new, glass, **fast)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(sorted(done) == list(range(len(prompts))), f"not every request finished: {sorted(done)}")
    check(all(len(done[u].tokens) == max_new for u in done), "a request stopped short")
    chunks = sum(-(-n // 128) for n in lens)
    check(all(launches[k] > 0 for k in SERVE_KERNELS), f"a kernel never launched: {launches}")
    check(launches["local_stats"] == cfg.n_layers * chunks and launches["flash_attention"] == 0,
          f"prefill kernels: {launches}, expected local stats once per layer and chunk "
          f"({chunks} chunks) and no flash attention")
    check(eng.pool.allocator.n_live == 0, "blocks still live after the drain")
    shared_equal = bool(np.array_equal(done[0].tokens, done[1].tokens))
    grouped = eng.grouped_rows
    del eng

    ops.reset_launch_counts()
    ref_eng, ref_done, ref_first, _, ref_wall = _serve(model, params, prior, prompts, max_new, glass,
                                                       glass_mode="masked", attn_mode="gather")
    check(all(ops.launch_counts()[k] == 0 for k in SERVE_KERNELS),
          f"the plain path launched a decode kernel: {ops.launch_counts()}")
    del ref_eng
    profile = _device_profile(lambda: _serve(model, params, prior, prompts, max_new, glass, **fast))
    rel = {u: ((first[u] - ref_first[u]).norm() / ref_first[u].norm()).item() for u in first}
    agree = float(np.mean(np.concatenate(
        [done[u].tokens == ref_done[u].tokens for u in done])))
    smi = nvidia_smi_line()
    report = {
        "phase": "serve", "model": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "requests": len(prompts), "prompt_lens": lens, "max_new": max_new,
        "launches": launches, "grouped_row_ticks": grouped,
        "shared_prompt_streams_equal": shared_equal,
        "decode_tok_s": times["decode"][1] / max(times["decode"][0], 1e-9),
        "prefill_tok_s": times["prefill"][1] / max(times["prefill"][0], 1e-9),
        "step_seconds": {k: v[0] for k, v in times.items()},
        "step_tokens": {k: v[1] for k, v in times.items()},
        "wall_s": wall, "plain_path_wall_s": ref_wall, "init_s": init_s,
        "max_memory_allocated_bytes": peak,
        "first_decode_logits_rel_l2": rel, "logits_rel_tol": LOGITS_REL_TOL,
        "first_decode_argmax_equal": {u: bool(first[u].argmax() == ref_first[u].argmax())
                                      for u in first},
        "token_agreement_vs_plain_path": agree, "profile": profile, "card": smi,
    }
    emit(report)
    rels = sorted(rel.values())
    check(float(np.median(rels)) <= LOGITS_REL_TOL["median"] and rels[-1] <= LOGITS_REL_TOL["max"],
          f"first-decode logits differ from the plain path beyond {LOGITS_REL_TOL}: {rel}")
    return launches


def env_phase():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    ptxas = {n: (build.BUILD_DIR / f"{n}.log").read_text() for n in build.KERNEL_SOURCES
             if (build.BUILD_DIR / f"{n}.log").exists()}
    emit({"phase": "env", "card": nvidia_smi_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "kernel_build_s": build_s, "ptxas": ptxas})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env_phase()
    summary = kernels_phase(Timer("cuda"))
    cfg, model, params, prior, init_s = llama_setup()
    launches = engine_phase(cfg, model, params, prior)
    for k, n in serve_phase(cfg, model, params, prior, init_s).items():
        launches[k] = launches.get(k, 0) + n
    check(all(launches[name] > 0 for name in KERNELS), f"a kernel never launched: {launches}")
    emit({"kernels": [
        dict(name=name, route="cuda", launches=launches[name], **KERNELS[name], **summary[name])
        for name in KERNELS
    ]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
