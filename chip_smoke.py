#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. card: name, power limit, torch/CUDA/nvcc versions; TF32 off for matmuls
   and convolutions (the plain versions are full float32);
2. build: the kernels (``tomosar2height_tpu_torch/csrc/*.cu``) with nvcc for
   sm_90a, into ``tomosar2height_tpu_torch/_build/``;
3. kernels: each kernel against its plain torch version at the flagship
   shapes (batch 8, 16384-point buckets on the aligned layout; the conv
   kernels K6-K8 at every shape of a batch-8 fusion forward), with the
   median time of each over 20 runs (3-5 for the conv chains; CUDA events),
   of one PyTorch library call computing the same function where there is
   one, and the bound (bytes over the HBM rate or fp32 operations over the
   fp32 peak, whichever is larger);
4. model: the full-width flagship network (random weights from a seed) on
   the ``fused2`` kernel path against the unsorted plain path;
5. serving: a synthetic city (the port's ``build_city``) through the port's
   loader and DSMGenerator at batch 8 on both paths, the GeoTIFF's data
   block read back, tiles/s, peak memory and the kernel launch counts of
   the timed run;
6. fusion-serve: the cloud+image fusion network (``fusion_config()``: the
   flagship plus the depth-6 image U-Net over the city's RGB image) serving
   the same city at batch 8 in three variants from one set of weights:
   fused2 + fused_convs + fused_head (K1-K4, K6, K7), unsorted with
   FAST_CONV (K8 only) and unsorted plain (no kernel); tiles/s, forward ms,
   peak memory and launches per forward of each, the launch counts asserted
   and the two kernel rasters held to the plain one;
7. train: the flagship training step (batch 8, 16384-point buckets, 8
   mini-steps per optimizer step, remat) on random patches of the same city
   with its nDSM as target, through the port's training loader and
   ``train/loop.py``, on the fused2 kernel path and the unsorted plain path
   from the same weights on the same patches: 1 warm-up and 2 timed
   optimizer steps each, window losses compared, mini-step ms, train
   patches/s, peak memory and the launches per fused2 mini-step.

Phase 3 also holds every backward (K5 at the eight levels, the pool2 and
scatter_plane2 backwards on K1/K2) against its plain version.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
kernel table as JSON: ``launches`` from the timed training run for K1-K5
and the backwards, from the timed fusion-serve runs for K6-K8 (each the
main path that runs it), ``launches_serve`` from the timed cloud-only
serving run. Imports nothing of JAX or of the JAX package
(``tomosar2height_tpu``), and checks that at the end. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
TOL = 1e-5  # f32 kernel vs plain, atol and rtol (the JAX package's own)
DEVICE = "cuda"
# the H100 SXM's published peaks (NVIDIA's H100 datasheet): HBM bytes/s
# and fp32 FLOP/s outside the tensor cores; a bound is the larger of bytes
# over the first and operations over the second
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
CITY = {"density": 0.06, "W": 2048, "H": 1536}  # ~16k points per 512 m tile, 35 tiles


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke runs only on a GPU")
    sys.path.insert(0, REPO)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    from tomosar2height_tpu_torch.ops.cuda import runtime

    nvcc = _run([runtime.nvcc_path(), "--version"]).splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {nvcc} | allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


def build():
    from tomosar2height_tpu_torch.ops.cuda import runtime

    t0 = time.perf_counter()
    runtime.library()
    info = runtime.BUILD_INFO
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "nvcc_build.log"), "w") as f:
        f.write(info["log"])
    log("build", f"{'built' if info['built'] else 'loaded'} {os.path.basename(info['path'])}"
        f" | nvcc {info['seconds']:.1f} s | load {time.perf_counter() - t0:.1f} s")
    return info


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    """(least ms the card could take, what bounds it) for a function that
    must move ``nbytes`` (inputs read once, outputs written once) and do
    ``flops`` fp32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def flagship_batch(seed: int, b: int = 8, n: int = 16384, reso: int = 256):
    """B patches of n uniform points (5% masked), unsorted and on the aligned
    layout (points, mask, cells, tile offsets; trimmed as the loader does)."""
    from tomosar2height_tpu_torch.ops.sorted_scatter import (
        host_morton_bucket_aligned,
        trim_aligned_batch,
    )

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.001, 0.999, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > 0.05
    aligned = [host_morton_bucket_aligned(pts[i], mask[i], reso) for i in range(b)]
    apts, amask, acell, toff = trim_aligned_batch(*(
        np.stack([a[k] for a in aligned]) for k in ("points", "mask", "cells", "tile_offsets")))
    return pts, mask, apts, amask, acell, toff


# (reso, F, Fl) of the eight level round trips of the flagship forward
LEVEL_SHAPES = [(256, 32, 32), (256, 64, 32), (128, 128, 64), (64, 256, 128),
                (32, 512, 256), (64, 256, 512), (128, 128, 256), (256, 64, 128)]


def _xavier(gen, fan_in, fan_out, device):
    import torch

    a = (6.0 / (fan_in + fan_out)) ** 0.5
    return ((torch.rand(fan_in, fan_out, generator=gen) * 2 - 1) * a).to(device)


def _compare(got, ref, atol=TOL, rtol=TOL):
    """(max |got - ref|, passes |d| <= atol + rtol*|ref| everywhere)."""
    d = (got - ref).abs()
    return float(d.max()), bool((d <= atol + rtol * ref.abs()).all())


# K5 (tests/test_fused_level_bwd.py:109-110): d_plane and d_c_last at 2e-5 abs
# + 2e-4 rel; weight gradients are sums over ~1e5 rows, so 3e-4 * max|ref| abs
# + 3e-4 rel
BWD_TOL = (2e-5, 2e-4)
WEIGHT_RTOL = 3e-4
# K5 is compared on the rows whose fc_comm pre-activations all lie at least
# this far from ReLU's kink (in the plain forward): the kernel and cuBLAS sum
# the pre-activation in other orders (they differ by a few 1e-6 at F=512), so
# at the kink one may open a gate the other keeps shut, and either is right.
# One such row moves its four pixels of d_plane by O(0.1) and dw_in as much.
KINK = 2e-5


def _weight_tol(ref):
    return WEIGHT_RTOL * float(ref.abs().max()), WEIGHT_RTOL


def _entry_fn(rows):
    def entry(name, source, replaces, pairs, kfn, pfn, work, lfn=None,
              tol=f"{TOL:g} abs+rel", iters=20):
        """pairs: (kernel, plain[, atol, rtol]) tuples; work: (bytes, flops)
        the function needs on these inputs; lfn: one PyTorch call computing
        the same function (timed as a yardstick), or None."""
        errs = [_compare(*pair) for pair in pairs]
        err = max(e for e, _ in errs)
        ok = all(o for _, o in errs)
        ms, plain_ms = cuda_ms(kfn, iters), cuda_ms(pfn, iters)
        lib_ms = cuda_ms(lfn, iters) if lfn is not None else None
        bound_ms, bound_by = bound(*work)
        log("kernels", f"{name}: max|d| {err:.3g} (tol {tol}) "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms | bound "
            f"{bound_ms:.4f} ms ({bound_by}: {work[0] / 1e9:.3f} GB, "
            f"{work[1] / 1e12:.4f} TFLOP)")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {err}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
    return entry


def check_kernels(seed: int = 0):
    """Each kernel against its plain version at the flagship shapes."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
    from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk
    from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d

    dev = torch.device(DEVICE)
    _, _, apts, amask, acell, _ = flagship_batch(seed)
    b, npad = amask.shape
    reso = 256
    gen = torch.Generator().manual_seed(seed)
    pts = torch.from_numpy(apts).to(dev)
    xy = pts[..., :2].contiguous()
    mask = torch.from_numpy(amask).to(dev)
    cells = torch.from_numpy(acell).to(dev)
    vals = (torch.randn(b, npad, 32, generator=gen).to(dev)
            * mask[..., None]).contiguous()
    log("kernels", f"B={b} Npad={npad} valid={int(amask.sum())} reso={reso}")
    rows = []

    entry = _entry_fn(rows)

    ncell = reso * reso
    pairs = []
    for kind in ("max", "mean", "sum"):
        k = pk.pool_reduce(vals, cells, mask, ncell, kind)
        p = pk.pool_reduce_plain(vals, cells, mask, ncell, kind)
        pairs.append((k, p))
    cellv = pairs[0][1]
    # the library yardsticks index the flat (B * ncell) cells; masked rows go
    # to one spare row
    nf = vals.shape[-1]
    flat = torch.where(mask & (cells >= 0),
                       cells + ncell * torch.arange(b, device=dev)[:, None],
                       torch.full_like(cells, b * ncell)).reshape(-1).long()
    flat_f = flat[:, None].expand(-1, nf)
    vals_flat = vals.reshape(-1, nf)
    out_bytes = b * ncell * nf * 4
    entry("pool_reduce", "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:46", pairs,
          lambda: pk.pool_reduce(vals, cells, mask, ncell, "max"),
          lambda: pk.pool_reduce_plain(vals, cells, mask, ncell, "max"),
          (nbytes(vals, cells, mask) + out_bytes, vals.numel()),
          lambda: torch.zeros(b * ncell + 1, nf, device=dev).scatter_reduce_(
              0, flat_f, vals_flat, "amax", include_self=False))
    entry("pool_gather", "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:133",
          [(pk.pool_gather(cellv, cells, mask),
            pk.pool_gather_plain(cellv, cells, mask))],
          lambda: pk.pool_gather(cellv, cells, mask),
          lambda: pk.pool_gather_plain(cellv, cells, mask),
          (nbytes(cellv, cells, mask, vals), 0),
          lambda: cellv.reshape(-1, nf).index_select(0, flat.clamp_max(b * ncell - 1)))
    kp, kc = pk.scatter_plane2(vals, cells, mask, reso)
    pp, pc = pk.scatter_plane2_plain(vals, cells, mask, reso)
    if not torch.equal(kc, pc):
        raise AssertionError("scatter_plane2 counts differ")
    entry("scatter_plane2", "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:263", [(kp, pp)],
          lambda: pk.scatter_plane2(vals, cells, mask, reso),
          lambda: pk.scatter_plane2_plain(vals, cells, mask, reso),
          (nbytes(vals, cells, mask, kp, kc), vals.numel()),
          lambda: torch.zeros(b * ncell + 1, nf, device=dev).scatter_reduce_(
              0, flat_f, vals_flat, "mean", include_self=False))

    # the backwards of pool2 (K1 mean/sum, then K2) and scatter_plane2 (K2)
    g = torch.randn(vals.shape, generator=gen).to(dev)
    pairs, bwd_args = [], []
    for kind in ("max", "mean"):
        out = pk.pool2(vals, cells, mask, reso, kind)
        a = (g, vals, out, cells, mask, reso, kind)
        pairs.append((pk.pool2_bwd(*a), pk.pool2_bwd_plain(*a)))
        bwd_args.append(a)
    entry("pool2_bwd", "tomosar2height_tpu_torch/ops/cuda/pool2_kernel.py",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:492", pairs,
          lambda: [pk.pool2_bwd(*a) for a in bwd_args],
          lambda: [pk.pool2_bwd_plain(*a) for a in bwd_args],
          (sum(nbytes(*a[:5], vals) for a in bwd_args), 2 * vals.numel()))
    g_plane = torch.randn(b, reso, reso, vals.shape[-1], generator=gen).to(dev)
    a = (g_plane, cells, mask, kc)
    entry("scatter_plane2_bwd", "tomosar2height_tpu_torch/ops/cuda/pool2_kernel.py",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:424",
          [(pk.scatter_plane2_bwd(*a), pk.scatter_plane2_bwd_plain(*a))],
          lambda: pk.scatter_plane2_bwd(*a), lambda: pk.scatter_plane2_bwd_plain(*a),
          (nbytes(*a, vals), vals.numel()))

    pairs, kfns, pfns = [], [], []
    bwd_pairs, bwd_k, bwd_p, red_pairs, red_k, red_p = [], [], [], [], [], []
    red_l = []
    work = {k: [0, 0] for k in ("level", "bwd", "reduce")}
    valid = int(mask.sum())
    for r, f, fl in LEVEL_SHAPES:
        plane = torch.randn(b, r, r, f, generator=gen).to(dev)
        c_last = (torch.randn(b, npad, fl, generator=gen).to(dev)
                  * mask[..., None]).contiguous()
        w = (_xavier(gen, f, 2 * f, dev), torch.zeros(2 * f, device=dev),
             _xavier(gen, 2 * f, f, dev), torch.zeros(f, device=dev),
             _xavier(gen, fl, f, dev), torch.zeros(f, device=dev))
        args = (plane, c_last, w, xy, cells, mask, r, reso)
        ko = lk.fused_level(*args)
        po = lk.fused_level_plain(*args)
        if not torch.equal(ko[2], po[2]):
            raise AssertionError(f"fused_level counts differ at {(r, f, fl)}")
        e0, e1 = _compare(ko[0], po[0]), _compare(ko[1], po[1])
        pairs += [(ko[0], po[0]), (ko[1], po[1])]
        work["level"][0] += nbytes(plane, c_last, xy, cells, mask, *w, *ko)
        work["level"][1] += 2 * valid * (4 * f * f + f * fl)
        kfns.append(lambda a=args: lk.fused_level(*a))
        pfns.append(lambda a=args: lk.fused_level_plain(*a))
        # K5 on random output cotangents, rows off the ReLU kink (KINK), with
        # the counts of the forward on those rows
        pre = grid_sample_2d(plane, xy) @ w[0] + w[1]
        mask5 = mask & ~(pre.abs() < KINK).any(-1)
        del pre
        counts5 = lk.fused_level(plane, c_last, w, xy, cells, mask5, r, reso)[2]
        g_p = torch.randn(b, r, r, f, generator=gen).to(dev)
        g_c = torch.randn(b, npad, f, generator=gen).to(dev)
        bargs = (plane, c_last, w, xy, cells, mask5, counts5, g_p, g_c, r, reso)
        kb, pb = lk.fused_level_bwd(*bargs), lk.fused_level_bwd_plain(*bargs)
        level_pairs = [(kb[0], pb[0], *BWD_TOL), (kb[1], pb[1], *BWD_TOL)]
        level_pairs += [(x, y, *_weight_tol(y)) for x, y in zip(kb[2], pb[2])]
        bwd_pairs += level_pairs
        work["bwd"][0] += nbytes(plane, c_last, xy, cells, mask5, counts5, g_p, g_c, *w,
                                 kb[0], kb[1], *kb[2])
        work["bwd"][1] += 2 * int(mask5.sum()) * (10 * f * f + 2 * f * fl)
        ed = max(_compare(*pair)[0] for pair in level_pairs)
        log("kernels", f"fused_level R={r} F={f} Fl={fl}: max|d| plane "
            f"{e0[0]:.3g} c_out {e1[0]:.3g} | backward {ed:.3g} on "
            f"{int(mask5.sum())} of {int(mask.sum())} rows (the rest within {KINK:g} "
            f"of the ReLU kink)")
        bwd_k.append(lambda a=bargs: lk.fused_level_bwd(*a))
        bwd_p.append(lambda a=bargs: lk.fused_level_bwd_plain(*a))
        # K5's reductions alone, on random rows of this level's shapes
        m = b * npad
        for ka, nb, bias in ((f, 2 * f, True), (2 * f, f, True), (fl, f, False)):
            ra = torch.randn(m, ka, generator=gen).to(dev)
            rb = torch.randn(m, nb, generator=gen).to(dev)
            kr = lk.level_bwd_reduce(ra, rb, bias)
            pr = lk.level_bwd_reduce_plain(ra, rb, bias)
            red_pairs += [(x, y, *_weight_tol(y)) for x, y in zip(kr, pr) if y is not None]
            work["reduce"][0] += nbytes(ra, rb, *kr)
            work["reduce"][1] += 2 * m * ka * nb
            red_l.append(lambda a=(ra, rb): torch.matmul(a[0].t(), a[1]))
            red_k.append(lambda a=(ra, rb, bias): lk.level_bwd_reduce(*a))
            red_p.append(lambda a=(ra, rb, bias): lk.level_bwd_reduce_plain(*a))
    entry("fused_level", "tomosar2height_tpu_torch/csrc/level.cu",
          "tomosar2height_tpu/ops/pallas/level_kernel.py:110", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], work["level"])
    bwd_tol = (f"{BWD_TOL[0]:g} abs + {BWD_TOL[1]:g} rel; weights "
               f"{WEIGHT_RTOL:g}*max|ref| abs + {WEIGHT_RTOL:g} rel")
    entry("fused_level_bwd", "tomosar2height_tpu_torch/csrc/level_bwd.cu",
          "tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:68", bwd_pairs,
          lambda: [fn() for fn in bwd_k], lambda: [fn() for fn in bwd_p], work["bwd"],
          tol=bwd_tol)
    entry("level_bwd_reduce", "tomosar2height_tpu_torch/csrc/level_bwd.cu",
          "tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:260", red_pairs,
          lambda: [fn() for fn in red_k], lambda: [fn() for fn in red_p], work["reduce"],
          lambda: [fn() for fn in red_l],
          tol=f"{WEIGHT_RTOL:g}*max|ref| abs + {WEIGHT_RTOL:g} rel")
    torch.cuda.synchronize()
    check_conv_kernels(entry, seed)
    return rows


# (H = W, Cin, C, pool) of the 20 conv pairs of a fusion forward (K7): the
# nine ALTO levels, then the eleven image U-Net levels; each pair is
# Cin -> C -> C. The decoder (K6): 512^2, 32 -> 64 -> 128 -> 64, head 288 -> 1.
ALTO_PAIRS = [(256, 32, 32, False), (256, 32, 64, False), (128, 64, 128, False),
              (64, 128, 256, False), (32, 256, 512, False), (64, 512, 256, False),
              (128, 256, 128, False), (256, 128, 64, False), (256, 64, 32, False)]
IMAGE_PAIRS = [(512, 3, 32, True), (256, 32, 64, True), (128, 64, 128, True),
               (64, 128, 256, True), (32, 256, 512, True), (16, 512, 1024, False),
               (32, 1024, 512, False), (64, 512, 256, False), (128, 256, 128, False),
               (256, 128, 64, False), (512, 64, 32, False)]
DECODER = (512, 32, (64, 128, 64), 1)
# (H = W, Cin, Cout) of the 43 Conv3x3 of a fusion forward under FAST_CONV (K8)
CONVS = ([c for h, cin, f, _ in ALTO_PAIRS + IMAGE_PAIRS for c in ((h, cin, f), (h, f, f))]
         + [(512, 32, 64), (512, 64, 128), (512, 128, 64)])


def _conv_w(gen, cin, cout, k, dev):
    """HWIO weights at std min(0.2, fan_in^-0.5), biases at std 0.1 (the
    tests' draw: activations stay O(1) through the chain)."""
    import torch

    std = min(0.2, (k * k * cin) ** -0.5)
    return ((torch.randn(k, k, cin, cout, generator=gen) * std).to(dev),
            (torch.randn(cout, generator=gen) * 0.1).to(dev))


def _check_or_explain(name, got, want, plain_fn, args):
    """Hold got to want at TOL; where they disagree, log each one's distance
    from a float64 run of the plain version, to show which side is off."""
    err, ok = _compare(got, want)
    if not ok:
        ref = plain_fn(*(a.double() for a in args))
        ref = ref[0] if isinstance(ref, tuple) else ref
        log("kernels", f"{name}: max|d| {err:.3g} over tol; against float64: kernel "
            f"{float((got.double() - ref).abs().max()):.3g}, plain "
            f"{float((want.double() - ref).abs().max()):.3g}")
    return got, want


def check_conv_kernels(entry, seed: int = 0):
    """K8 at the 43 convs, K7 at the 20 pairs and K6 at the decoder of a
    batch-8 fusion forward, each against its plain version; K8 also beside
    one ``F.conv2d`` (cuDNN, full fp32) per conv."""
    import torch
    import torch.nn.functional as F

    from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
    from tomosar2height_tpu_torch.ops.cuda import convpair_kernel as cpk
    from tomosar2height_tpu_torch.ops.cuda import decoder_kernel as dk

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 7)
    b = 8
    x_of = lambda h, c: torch.randn(b, h, h, c, generator=gen).to(dev)  # noqa: E731

    pairs, kfns, pfns, lfns, work = [], [], [], [], [0, 0]
    for h, cin, cout in CONVS:
        x = x_of(h, cin)
        w, bias = _conv_w(gen, cin, cout, 3, dev)
        args = (x, w, bias)
        pairs.append(_check_or_explain(f"conv3x3 {h}^2 {cin}->{cout}", ck.conv3x3(*args, True),
                                       ck.conv3x3_plain(*args, True),
                                       lambda *a: ck.conv3x3_plain(*a, True), args))
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        work[0] += nbytes(x, w, bias) + b * h * h * cout * 4
        work[1] += 2 * b * h * h * 9 * cin * cout
        kfns.append(lambda a=args: ck.conv3x3(*a, True))
        pfns.append(lambda a=args: ck.conv3x3_plain(*a, True))
        lfns.append(lambda a=(x_nchw, w_oihw, bias): F.conv2d(*a, padding=1))
    entry("conv3x3", "tomosar2height_tpu_torch/csrc/conv.cu",
          "tomosar2height_tpu/ops/pallas/conv_kernel.py:43", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], work,
          lambda: [fn() for fn in lfns], iters=3)
    del pairs, kfns, pfns, lfns

    pairs, kfns, pfns, work = [], [], [], [0, 0]
    for h, cin, c, pool in ALTO_PAIRS + IMAGE_PAIRS:
        x = x_of(h, cin)
        args = (x, *_conv_w(gen, cin, c, 3, dev), *_conv_w(gen, c, c, 3, dev))
        ky, kp = cpk.conv_pair(*args, pool)
        py, pp = cpk.conv_pair_plain(*args, pool)
        name = f"conv_pair {h}^2 {cin}->{c}->{c}"
        pairs.append(_check_or_explain(name, ky, py, lambda *a: cpk.conv_pair_plain(*a, pool),
                                       args))
        if pool:
            pairs.append((kp, pp))
        work[0] += nbytes(*args, ky, kp)
        work[1] += 2 * b * h * h * 9 * (cin * c + c * c)
        kfns.append(lambda a=args, p=pool: cpk.conv_pair(*a, p))
        pfns.append(lambda a=args, p=pool: cpk.conv_pair_plain(*a, p))
    entry("conv_pair", "tomosar2height_tpu_torch/csrc/convpair.cu",
          "tomosar2height_tpu/ops/pallas/convpair_kernel.py:36", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], work, iters=3)
    del pairs, kfns, pfns

    h, c0, (c1, c2, c3), co = DECODER
    x = x_of(h, c0)
    args = (x, *_conv_w(gen, c0, c1, 3, dev), *_conv_w(gen, c1, c2, 3, dev),
            *_conv_w(gen, c2, c3, 3, dev), *_conv_w(gen, c0 + c1 + c2 + c3, co, 1, dev))
    got = dk.conv_decoder(*args)
    flops = 2 * b * h * h * (9 * (c0 * c1 + c1 * c2 + c2 * c3) + (c0 + c1 + c2 + c3) * co)
    entry("conv_decoder", "tomosar2height_tpu_torch/csrc/decoder.cu",
          "tomosar2height_tpu/ops/pallas/decoder_kernel.py:85",
          [_check_or_explain("conv_decoder", got, dk.conv_decoder_plain(*args),
                             dk.conv_decoder_plain, args)],
          lambda: dk.conv_decoder(*args), lambda: dk.conv_decoder_plain(*args),
          (nbytes(*args, got), flops), iters=5)
    torch.cuda.synchronize()


def flagship_model(seed: int):
    """The full-width flagship network, weights from a seeded generator."""
    import torch

    from tomosar2height_tpu_torch.config import flagship_config
    from tomosar2height_tpu_torch.models import build_model, init_weights

    cfg = flagship_config()
    model = init_weights(build_model(cfg, DEVICE), torch.Generator().manual_seed(seed))
    return cfg, model.eval()


def _height_tol(cfg) -> float:
    z = cfg["dataset"]["normalize"]["z_bound"]
    return 2e-4 * (z[1] - z[0])


def check_model(seed: int = 0):
    """fused2 kernel path against the unsorted plain path, batch 8."""
    import torch

    cfg, model = flagship_model(seed)
    pts, mask, apts, amask, _, toff = flagship_batch(seed + 1)
    up = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    fused_args = (up(apts), up(amask), None, None, up(toff))
    plain_args = (up(pts), up(mask))
    with torch.inference_mode():
        h_fused, _ = model(*fused_args)
        h_plain, _ = model(*plain_args)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: model(*fused_args), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: model(*plain_args), iters=5, warmup=1)
    side = cfg["model"]["decoder_pixel_kwargs"]["output_size"]
    if h_fused.shape != (pts.shape[0], side, side, 1) or not torch.isfinite(h_fused).all():
        raise AssertionError(f"bad heights: {tuple(h_fused.shape)}")
    err = float((h_fused - h_plain).abs().max())
    tol = _height_tol(cfg)
    log("model", f"fused2 vs plain heights {tuple(h_fused.shape)}: max|d| {err:.3g} m "
        f"(tol {tol:.3g} m) | |h| max {float(h_plain.abs().max()):.3g} m | "
        f"forward fused2 {ms:.1f} ms, plain {plain_ms:.1f} ms (median of 5)")
    if err > tol:
        raise AssertionError(f"fused2 and plain heights differ by {err} m")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def serve(seed: int = 0):
    """A synthetic city through the port's loader and DSMGenerator, batch 8,
    on the fused2 kernel path (timed, launches counted) and the plain path."""
    import tempfile

    import torch

    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.infer.generator import make_generator
    from tomosar2height_tpu_torch.ops.cuda import runtime

    w, h = CITY["W"], CITY["H"]
    _, pts, _ = build_city(seed, **CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    cfg, model = flagship_model(seed)
    gen = make_generator(model, cfg, chunks)
    plain_cfg = json.loads(json.dumps(cfg))
    plain_cfg["dataset"]["points"]["sort"] = False
    plain_gen = make_generator(model, plain_cfg, chunks)
    n_batches = len(gen.data_loader)
    with tempfile.TemporaryDirectory() as tmp:
        gen.generate_dsm(os.path.join(tmp, "warmup.tif"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_launches()
        a = gen.generate_dsm(os.path.join(tmp, "fused2.tif"))
        launches = dict(runtime.LAUNCHES)
        stats = dict(gen.last_stats)
        peak = torch.cuda.max_memory_allocated()
        b = plain_gen.generate_dsm(os.path.join(tmp, "plain.tif"))
        if runtime.LAUNCHES != launches:
            raise AssertionError("the plain path launched a kernel")
        da, db = a.data, b.data
        shape_ok = da.shape == db.shape == (h, w) and a.transform == b.transform
        # one uncompressed f32 band: the file ends in the raster's bytes
        for r, name in ((a, "fused2.tif"), (b, "plain.tif")):
            path = os.path.join(tmp, name)
            back = np.fromfile(path, "<f4", offset=os.path.getsize(path) - r.data.nbytes)
            if not np.array_equal(back.reshape(r.data.shape), r.data, equal_nan=True):
                raise AssertionError(f"{name} does not hold the generated raster")
    nan = np.isnan(db)
    if not shape_ok or not np.array_equal(np.isnan(da), nan) or nan.all():
        raise AssertionError(f"rasters differ in shape/transform/NaN mask: {da.shape}")
    err = float(np.abs(da[~nan] - db[~nan]).max())
    tol = _height_tol(cfg)
    want = {**dict.fromkeys(launches, 0), "pool_reduce": 4 * n_batches,
            "pool_gather": 4 * n_batches, "scatter_plane2": n_batches,
            "fused_level": 8 * n_batches}
    log("serve", f"{stats['n_patches']} tiles in {n_batches} batches of "
        f"{gen.data_loader.batch_size} | "
        f"{stats['patches_per_s']:.2f} tiles/s ({stats['total_s']:.3f} s: loader "
        f"{stats['loader_s']:.3f} dispatch {stats['dispatch_s']:.3f} wait "
        f"{stats['fetch_wait_s']:.3f} blend {stats['blend_cpu_s']:.3f} write "
        f"{stats['finalize_write_s']:.3f}) | peak {peak / 2**30:.2f} GiB | raster "
        f"{da.shape} fused2 vs plain max|d| {err:.3g} m (tol {tol:.3g} m), "
        f"NaN px {int(nan.sum())} | launches {launches}")
    if err > tol:
        raise AssertionError(f"fused2 and plain rasters differ by {err} m")
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    return launches


# kernel launches per batch-8 forward of the fusion network on its kernel
# path (fused2 + fused_convs + fused_head; the footprint head is skipped when
# serving) and on the FAST_CONV path (unsorted, every Conv3x3 on K8)
FUSION_LAUNCHES = {"pool_reduce": 4, "pool_gather": 4, "scatter_plane2": 1,
                   "fused_level": 8, "conv_pair": len(ALTO_PAIRS + IMAGE_PAIRS),
                   "conv_decoder": 1}
FAST_CONV_LAUNCHES = {"conv3x3": len(CONVS)}


def fusion_serve(seed: int = 0):
    """The cloud+image fusion network serving the synthetic city with its RGB
    image, batch 8, in three variants from the same weights: (a) fused2 +
    fused_convs + fused_head (K1-K4, K6, K7), (b) unsorted with FAST_CONV (K8
    only), (c) unsorted plain (no kernel). Each timed run is the second
    ``generate_dsm`` of its variant, launches counted from 0 around it; (a)
    and (b) are held to (c)."""
    import tempfile

    import torch

    from tomosar2height_tpu_torch.config import fusion_config
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import RasterData
    from tomosar2height_tpu_torch.infer.generator import make_generator
    from tomosar2height_tpu_torch.models import build_model, init_weights
    from tomosar2height_tpu_torch.models.blocks import set_fast_conv
    from tomosar2height_tpu_torch.ops.cuda import runtime

    w, h = CITY["W"], CITY["H"]
    _, pts, rgb = build_city(seed, **CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    image = (rgb, RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0)))
    cfg = fusion_config()
    model = init_weights(build_model(cfg, DEVICE), torch.Generator().manual_seed(seed))
    plain_cfg = json.loads(json.dumps(cfg))
    plain_cfg["dataset"]["points"]["sort"] = False
    plain_cfg["model"]["encoder_kwargs"]["unet_kwargs"]["fused_convs"] = False
    plain_cfg["model"]["encoder2_kwargs"]["fused_convs"] = False
    plain_cfg["model"]["decoder_pixel_kwargs"]["fused_head"] = False
    plain_model = build_model(plain_cfg, DEVICE)
    plain_model.load_state_dict(model.state_dict())
    variants = {"kernels": (cfg, model.eval(), False, FUSION_LAUNCHES),
                "fast_conv": (plain_cfg, plain_model.eval(), True, FAST_CONV_LAUNCHES),
                "plain": (plain_cfg, plain_model, False, {})}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (vcfg, vmodel, fast, per_batch) in variants.items():
            set_fast_conv(fast)
            gen = make_generator(vmodel, vcfg, chunks, image=image)
            n_batches = len(gen.data_loader)
            batch = next(iter(gen.data_loader))
            up = {k: torch.from_numpy(batch[k]).to(DEVICE)
                  for k in ("points", "point_mask", "image", "cell_offsets") if k in batch}
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: vmodel(up["points"], up["point_mask"], up["image"],
                                                None, up.get("cell_offsets"),
                                                footprint=False), iters=3, warmup=1)
            gen.generate_dsm(os.path.join(tmp, "warmup.tif"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runtime.reset_launches()
            r = gen.generate_dsm(os.path.join(tmp, f"{name}.tif"))
            torch.cuda.synchronize()
            launches = dict(runtime.LAUNCHES)
            set_fast_conv(False)
            stats = gen.last_stats
            want = {k: per_batch.get(k, 0) * n_batches for k in launches}
            out[name] = {"raster": r.data, "transform": r.transform, "launches": launches,
                         "fwd_ms": fwd_ms}
            log("fusion-serve", f"{name}: {stats['n_patches']} tiles in {n_batches} batches "
                f"| {stats['patches_per_s']:.2f} tiles/s ({stats['total_s']:.3f} s: loader "
                f"{stats['loader_s']:.3f} dispatch {stats['dispatch_s']:.3f} wait "
                f"{stats['fetch_wait_s']:.3f} blend {stats['blend_cpu_s']:.3f} write "
                f"{stats['finalize_write_s']:.3f}) | forward {fwd_ms:.1f} ms per batch "
                f"(median of 3) | peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
                f"launches per forward {({k: v / n_batches for k, v in launches.items() if v})}")
            if launches != want:
                raise AssertionError(f"{name}: launch counts {launches}, expected {want}")
    ref = out["plain"]["raster"]
    nan = np.isnan(ref)
    if ref.shape != (h, w) or nan.all():
        raise AssertionError(f"bad plain raster {ref.shape}")
    tol = _height_tol(cfg)
    for name in ("kernels", "fast_conv"):
        da = out[name]["raster"]
        if (da.shape != ref.shape or out[name]["transform"] != out["plain"]["transform"]
                or not np.array_equal(np.isnan(da), nan)):
            raise AssertionError(f"{name}: raster differs from plain in shape/transform/NaN")
        err = float(np.abs(da[~nan] - ref[~nan]).max())
        log("fusion-serve", f"{name} vs plain raster {da.shape}: max|d| {err:.3g} m (tol "
            f"{tol:.3g} m), NaN px {int(nan.sum())}, |h| max {float(ref[~nan].max()):.3g} m")
        if err > tol:
            raise AssertionError(f"{name} and plain rasters differ by {err} m")
    return {k: v for name in ("kernels", "fast_conv")
            for k, v in out[name]["launches"].items() if v}


# kernel launches of one fused2 training mini-step with remat: the encoder's
# forward (K1 4, K2 4, K3 1, K4 8) runs twice, the second time recomputed in
# the backward; the backward adds the max-pools' K1 'sum' + K2 (4 each), the
# plane scatter's K2 (1) and K5 at the eight levels (a row pass and three
# weight-gradient reductions each)
TRAIN_LAUNCHES = {"pool_reduce": 12, "pool_gather": 13, "scatter_plane2": 2,
                  "fused_level": 16, "fused_level_bwd": 8, "level_bwd_reduce": 24,
                  "pool2_bwd": 4, "scatter_plane2_bwd": 1}


def train_phase(seed: int = 0):
    """The flagship training step on random patches of the synthetic city,
    fused2 kernel path against the unsorted plain path from the same weights
    on the same patches: 1 warm-up and 2 timed optimizer steps each."""
    import torch

    from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import RasterData
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.train import Trainer, build_scheduler, train

    w, h = CITY["W"], CITY["H"]
    ndsm, pts, _ = build_city(seed, **CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    dsm = (ndsm, RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0)))
    cfg, model = flagship_model(seed)
    tcfg, dcfg = cfg["training"], cfg["dataset"]
    bsz, k = tcfg["batch_size"], tcfg["optimize_every"]
    reso = cfg["model"]["encoder_kwargs"]["plane_resolution"]
    state0 = {n: v.detach().clone() for n, v in model.state_dict().items()}
    runs = {}
    for name, sort in (("fused2", True), ("plain", False)):
        # one optimizer step's patches per epoch; det_stream keys every patch
        # and subsample by (seed, epoch, position): both paths see the same
        ds = SceneDataset(chunks, dcfg, random_sample=True, random_length=bsz * k,
                          dsm=dsm)
        loader = PatchLoader(ds, bsz, dcfg["points"]["bucket_sizes"],
                             fixed_bucket=dcfg["points"]["train_bucket"],
                             sort_reso=reso if sort else None, shuffle=True,
                             drop_last=True, seed=seed, det_stream=True)
        model.load_state_dict(state0)
        trainer = Trainer(model, tcfg)
        sched = build_scheduler(tcfg)
        warm = train(trainer, sched, loader, tcfg, max_iteration=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_launches()
        t0 = time.perf_counter()
        out = train(trainer, sched, loader, tcfg, max_iteration=2)
        wall = time.perf_counter() - t0
        launches = dict(runtime.LAUNCHES)
        losses = [r["loss"] for r in warm["windows"] + out["windows"]]
        moved = any(not torch.equal(v, state0[n]) for n, v in model.state_dict().items())
        runs[name] = {"losses": losses, "ms": out["median_step_ms"],
                      "patches_s": out["n_patches"] / wall, "wall": wall,
                      "n": out["n_ministeps"], "patches": out["n_patches"],
                      "peak": torch.cuda.max_memory_allocated(), "launches": launches,
                      "lrs": [r["lr"] for r in warm["windows"] + out["windows"]],
                      "grad_norm": [r["grad_norm"] for r in warm["windows"] + out["windows"]]}
        r = runs[name]
        log("train", f"{name}: window losses {[f'{x:.6f}' for x in losses]} | grad_norm "
            f"{[f'{x:.4g}' for x in r['grad_norm']]} | lr {r['lrs']} | mini-step "
            f"{r['ms']:.1f} ms (median of {r['n']}, CUDA events) | {r['patches']} "
            f"patches in {wall:.3f} s = {r['patches_s']:.2f} train patches/s | peak "
            f"{r['peak'] / 2**30:.2f} GiB | parameters moved {moved}")
        if not all(np.isfinite(losses)) or not moved:
            raise AssertionError(f"{name}: losses {losses}, parameters moved {moved}")
    fused, plain = runs["fused2"], runs["plain"]
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain path launched kernels: {plain['launches']}")
    want = {**dict.fromkeys(fused["launches"], 0),
            **{key: v * fused["n"] for key, v in TRAIN_LAUNCHES.items()}}
    per_step = {key: v / fused["n"] for key, v in fused["launches"].items()}
    # the L1 loss moves by at most the heights' own difference: the model
    # phase's bound
    tol = _height_tol(cfg)
    err = max(abs(a - b) for a, b in zip(fused["losses"], plain["losses"]))
    log("train", f"fused2 vs plain window losses: max|d| {err:.3g} m (tol {tol:.3g} m) | "
        f"mini-step fused2 {fused['ms']:.1f} ms, plain {plain['ms']:.1f} ms | launches per "
        f"fused2 mini-step {per_step}")
    if err > tol:
        raise AssertionError(f"fused2 and plain window losses differ by {err} m")
    if fused["launches"] != want:
        raise AssertionError(f"launch counts {fused['launches']}, expected {want}")
    return fused["launches"]


def main():
    card()
    build()
    rows = check_kernels()
    check_model()
    serve_launches = serve()
    fusion_launches = fusion_serve()
    launches = train_phase()
    import torch

    for row in rows:
        # K1-K5 and the backwards: the training step; K6-K8: fusion serving
        row["launches"] = launches.get(row["name"]) or fusion_launches[row["name"]]
        row["launches_serve"] = serve_launches.get(row["name"], 0)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "tomosar2height_tpu"))
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
