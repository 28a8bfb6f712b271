#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. card: name, power limit, torch/CUDA/nvcc versions; TF32 off for matmuls
   and convolutions (the plain versions are full float32);
2. build: the kernels (``tomosar2height_tpu_torch/csrc/*.cu``) with nvcc for
   sm_90a, into ``tomosar2height_tpu_torch/_build/``; ptxas's register
   counts of the tensor-core kernels (K4, K5's row pass and reduction, the
   implicit-GEMM conv of K6-K8 and K6's head conv, and the two wgmma
   kernels: K5's bf16 weight sums and K8 in bf16), and a check that the
   SASS of every instance of each holds TF32 tensor-core instructions
   (HMMA; ``cuobjdump -sass``), BF16 ones in every bf16 instance (K4,
   K5's row pass, the conv core; the f32 weight sums have no bf16
   instance), and bf16 warpgroup products (HGMMA) and TMA loads (UTMALDG)
   in every instance of the wgmma kernels;
3. kernels: each kernel against its plain torch version at the flagship
   shapes (batch 8, 16384-point buckets on the aligned layout, whose
   largest run of one cell is logged; the conv
   kernels K6-K8 at every shape of a batch-8 fusion forward, held to their
   plain versions run in float64 on the same inputs), with the
   median device time of each over 20 samples (3-5 for the conv chains;
   CUDA graph replays, ``graph_ms``; the rows of ``pool2.cu`` on three
   copies of their inputs in turn, so that L2 does not hold them), of one
   PyTorch library call computing the same function where there is
   one, and the bound (bytes over the HBM rate or operations over the peak
   of the kernel's route, whichever is larger: fp32 FMA, or 3xTF32 on the
   tensor cores for K4, K5 (its row pass and weight sums, each also a row of
   its own) and K6-K8 (K6's head on fp32 FMA), whose log lines also give the
   bound were those operations on fp32 FMA); then K6-K8 on bf16 activations
   at the same shapes (rows ``conv3x3_bf16``, ``conv_pair_bf16``,
   ``conv_decoder_bf16``: each within twice its bf16 plain version's
   distance from float64 plus one bf16 ulp, bit-equal on a second launch,
   bound at the bf16 tensor-core rate; K8 beside ``F.conv2d`` in bf16); and
   K1-K5 with their backwards in bf16 at the flagship shapes (rows
   ``*_bf16``: the run kernels, K2 and K5's d_plane pass and weight sums
   within one bf16 ulp of their bf16 plain versions, pool2's max exact; K4,
   K5 and its row pass under the JAX package's bf16 rule, BF16_RULE; each
   bit-equal on a second launch, K4 also over STRESS_LAUNCHES; bound at the
   bf16 tensor-core rate, bf16 library yardsticks); and K9-K14 with the
   'fused' layout's backwards in bf16 at the shapes of their f32 rows (rows
   ``*_bf16``: within one bf16 ulp of their bf16 plain versions, the max
   exact, each bit-equal on a second launch, bounds in bf16 bytes, bf16
   library yardsticks), with the d_plane pass from f32 cotangents into a
   bf16 plane (``level_d_plane_wide_bf16``, the 'cumsum' samples' backward);
4. model: the full-width flagship network (random weights from a seed) on
   the ``fused2`` kernel path against the unsorted plain path;
5. serving: a synthetic city (the port's ``build_city``) through the port's
   loader and DSMGenerator at batch 8 on both paths, the GeoTIFF's data
   block read back, tiles/s, peak memory and the kernel launch counts of
   the timed run (the synchronous loader), its raster held bit-equal to the
   warm-up run's; then the loader with SERVE_WORKERS patch threads and a
   prefetch thread SERVE_PREFETCH batches ahead, its raster bit-equal to the
   synchronous one, tiles/s and loader seconds of both;
6. fusion-serve: the cloud+image fusion network (``fusion_config()``: the
   flagship plus the depth-6 image U-Net over the city's RGB image) serving
   the same city at batch 8 in three variants from one set of weights
   (forward ms: the model's forward on one batch):
   fused2 + fused_convs + fused_head (K1-K4, K6, K7), unsorted with
   FAST_CONV (K8 only) and unsorted plain (no kernel); tiles/s, forward ms,
   peak memory and launches per forward of each, the launch counts asserted
   and the two kernel rasters held to the plain one, each variant's timed
   raster bit-equal to its warm-up run's (the unsorted paths' plain segment
   ops and gathers add in a fixed order, ops/scatter.py); then the kernel
   path on every wire
   (u16 points, u8 image crops cut on the card from the resident scene
   image, the host's cell ids, f16 tile rasters), held to the f32 wires'
   raster within the JAX package's bounds for them (the u16 one on the
   distribution, the f16 rounding of the heights) with equal NaN masks,
   its forward ms the model's plus the wires' work on the card (the crops,
   the u8 normalisation, the f16 cast);
7. train: the flagship training step (batch 8, 16384-point buckets,
   TRAIN_OPTIMIZE_EVERY mini-steps per optimizer step, remat) on random
   patches of the same city
   with its nDSM as target, through the port's training loader and
   ``train/loop.py``, on the fused2 kernel path and the unsorted plain path
   from the same weights on the same patches: 1 warm-up and 1 timed
   optimizer step each, window losses compared, mini-step ms, train
   patches/s, peak memory and the launches per fused2 mini-step; then the
   fused2 run once more from the same weights on the same patches, whose
   parameters and window losses must be bit-equal to the first run's (every
   kernel writes each output once in a fixed order, and the step keeps
   cuDNN to deterministic algorithms; which tensors differ is logged by
   module).

8. sorted-serve: the same city served with ``sorted_config(impl)`` for
   impl 'fused' (K9, K10, K12), 'pallas' (K11; with mean pooling also K13)
   and 'cumsum' (no kernel) from one set of weights, each raster held to the
   unsorted plain path's, launches per forward asserted;
9. munich-depth6: one batch-8 fused2 forward at ALTO depth 6, whose first up
   level runs K4 at Fl = 1024, held to the plain path;
10. sorted-train: the flagship on the 'fused' layout with flip/rotate
   augmentation (``sorted_config('fused')``), batch 8, 8 mini-steps per
   optimizer step, det_stream, the loader's prefetch thread: a warm-up and a
   timed optimizer step; the first step again on the unsorted plain path on
   the same patches (window losses within 2e-4 * z_scale) and on 'fused'
   from the same weights (every parameter and the window loss bit-equal to
   the first run's after that step: K9, K10 and K12's backwards add in fixed
   orders), launches per mini-step asserted (SORTED_TRAIN_LAUNCHES), train
   patches/s, mini-step ms and peak memory; one 'cumsum' step and its rerun,
   bit-equal as well (differing tensors counted; its samples' backward on
   K5's d_plane pass, CUMSUM_TRAIN_LAUNCHES); 'pallas' refused by
   ``cli.train`` in a child process beside the steps;
11. headline-train: the headline network (``headline_config()``: the
   cloud+image network with ALTO depth 6 and the footprint head) trained at
   full width, batch 8, ``optimize_every`` 4, on random patches of the city
   with its nDSM and RGB image: the kernel path (fused2 + K6/K7) for
   HEADLINE_STEPS (2) optimizer steps, a checkpoint after each, through
   ``train/loop.py``
   (launches per mini-step asserted against HEADLINE_TRAIN_LAUNCHES), the
   plain path from the same weights on the same patches for the first step
   (its window's loss_l1 and loss_ce held within their tolerances) and that
   step once more (0 of 237 tensors may differ, window losses equal), the
   checkpoint's
   size and round trip, then a child process that resumes from the
   iteration-1 checkpoint and runs iteration 2: its parameters must be
   bit-equal to the uninterrupted run's and its window losses equal;
12. bf16: the headline network in bf16 (``model.dtype=bfloat16``) on its
   fused2 kernel path at full width (K1-K5 and K6/K7 at their bf16
   instances) against the same network in f32 from the same weights
   (``bf16_phase``): serving bf16 and f32 on fused2 (launches asserted, the
   bf16 raster bit-equal to its warm-up's) and bf16 on the unsorted path
   (its raster bit-equal to its warm-up's too), each bf16 raster within the
   JAX package's bf16 gate of the f32 one; a warm-up and a timed optimizer
   step (``optimize_every`` 4) on headline-train's patches, window losses
   within 0.15 x scale of headline-train's f32 kernel run, the bf16 first
   step rerun from the same weights, every parameter and the loss
   bit-equal; the first step on the unsorted path in bf16 (the conv
   kernels' flags on) twice, 0 of 237 tensors apart; then the sorted
   layouts in bf16 (``sorted_bf16``): the city served on 'fused', 'pallas'
   (and one batch with mean pooling, K13) and 'cumsum' from sorted-serve's
   weights, each raster within the bf16 gate of sorted-serve's f32 raster on
   its layout, bit-equal to its warm-up, launches asserted (every kernel at
   its bf16 instance, no f32 launch); a warm-up and a timed optimizer step on
   'fused' and on 'cumsum' from sorted-train's weights on its patches, window
   losses within 0.15 x scale of its f32 windows, the first step rerun: 0
   tensors apart, losses equal;
13. cli: the entry points on the city written to disk (``write_city``: LAS,
   nDSM, masks, RGB): ``cli.build_dataset`` (two 1024 m chunks),
   ``cli.train`` (the headline network at full width, batch 8,
   ``optimize_every`` 4, 2 iterations, validation, a checkpoint and the vis
   split's nDSM at the second) and ``cli.test`` on the checkpoint it wrote; the
   build's seconds, train patches/s, test tiles/s, the checkpoint's MiB and
   the report's RMSE/MAE/NMAD beside the card's name and power limit; the
   test raster bit-equal to an in-process DSMGenerator that loads the same
   checkpoint over the in-memory SceneDataset of the same city, the report's
   statistics within STAT_TOL of a float64 recomputation from the two
   rasters, ``metrics.jsonl`` holding both iterations' losses and ``nDSM/``
   entries, and every kernel of the path launched; then in bf16
   (``model.dtype=bfloat16``) ``cli.train`` one iteration and ``cli.test``
   on the f32 checkpoint, the raster within the bf16 gate of the f32 one,
   every bf16 kernel of the training path launched.

Phase 3 also holds every backward (K5 at the eight levels: its row pass,
its d_plane pass (a block a tile of pixels; each pixel the rows of its
rectangle of finest cells in a fixed order; beside ``F.grid_sample``'s
backward) and its weight
sums, each a row of its own, pool2's on its run kernel (K1 + K2 in one
launch, forward and backward each run twice and held bit-equal),
scatter_plane2's on K2 alone (a warp a 32-row span, each run's cell read
once; held bit-equal on a second launch) against its plain version, K4/K5
at the depth-6 level (R, F, Fl) = (32, 512, 1024), and K9-K14 at every
shape of a flagship forward on the 'fused' and 'pallas' layouts, and the
'fused' layout's backwards at every shape of its training step (K9's on
K5's d_plane pass, K10's on the run kernel with max's cotangent split among
tied rows, on integral values too, K12's on K2 alone with the forward's
counts), each bit-equal on a second launch. K3, K4's
plane and K11-K14 run on the run scatter (``scatter_runs``: each run's
cell written once, the empty cells zeroed in the same launch; K13 in Morton
order), K10 on pool2's run kernel under the tile rule; K4, K5 (and its
d_plane pass alone) and every run kernel are also held bit-equal on a
second launch, and K4 at each flagship level over STRESS_LAUNCHES launches
(``stress_level``), in f32 and in bf16. K10-K13 are timed on three copies of their inputs, K10
logged by kind, K11 and K13 at each of their 9 shapes and K12 at each of
its 10. Bounds count per-row inputs only on the rows a kernel reads them
for.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
kernel table as JSON: ``launches`` from the timed training run for K1-K5
and the backwards, from the timed fusion-serve runs and the headline-train
kernel run for K6 and K7, from the fusion-serve runs for K8, from the
timed sorted-serve runs for K9-K12 and its mean-pooling batch for K13 (each
the main path that runs it; K14 is on none, 0 in both dtypes; so is
``pool2_mean``, the run kernel's mean pooling, as the flagship pools by max;
the bf16 rows from the bf16 phase's timed serving and training runs, those
of K9-K13 and their backwards from its sorted runs), from the timed
'fused' training run for the fused layout's backwards, ``launches_serve`` from the
timed cloud-only serving run, ``launches_sorted_train`` from that 'fused'
training run, ``launches_cli`` from the "cli" phase. Each phase's seconds are
logged ("time"). Imports nothing of JAX or of the JAX package
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
# the H100 SXM's published peaks (NVIDIA's H100 datasheet, 700 W): HBM
# bytes/s, fp32 FLOP/s outside the tensor cores, dense TF32 FLOP/s on them; a
# bound is the larger of bytes over the HBM rate and operations over the rate
# of the kernel's route: fp32 FMA, or 3xTF32 (K4, K5, K6-K8: three TF32
# products per fp32 product, so a third of the TF32 rate)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
TF32X3_FLOP_S = TF32_FLOP_S / 3
# dense bf16 FLOP/s on the tensor cores: the bf16 conv kernels (K6-K8 on bf16
# activations, one bf16 product per product)
BF16_FLOP_S = 989e12
# the kernels that must hold warp-level tensor-core instructions (HMMA) in
# their SASS: K4, K5's row pass and f32 weight-gradient reduction, the
# implicit-GEMM conv of K6's first two passes, K7 and K8's flat-K route, and
# K6's third conv with the head; TF32 HMMA in every f32 instance, bf16 HMMA
# in every bf16 instance (each kernel has some, but F32_ONLY's: the f32
# weight sums, whose bf16 instance is atb_wgmma, K4, whose bf16 instance is
# fused_level_wgmma, and K5's row pass, whose bf16 instance is
# fused_level_bwd_wgmma)
MMA_SYNC_KERNELS = ("fused_level_fwd", "fused_level_bwd_rows", "atb_mma",
                    "conv3x3_igemm", "conv3x3_head_igemm")
F32_ONLY = ("atb_mma", "fused_level_fwd", "fused_level_bwd_rows")
# the kernels on Hopper's warpgroup products fed by the TMA: K5's bf16
# weight sums (csrc/reduce_bf16.cu), K8 and both convs of K7 in bf16
# (csrc/conv_bf16.cu), K4 in bf16 (csrc/level_bf16.cu) and K5's bf16 row
# pass (csrc/level_bwd_bf16.cu); bf16 HGMMA and UTMALDG in every instance
WGMMA_KERNELS = ("atb_wgmma", "conv3x3_wgmma", "fused_level_wgmma", "fused_level_bwd_wgmma")
TENSOR_CORE_KERNELS = MMA_SYNC_KERNELS + WGMMA_KERNELS
# the run kernels of csrc/pool2.cu (K1 + K2 on pool2's path, K10; K2 alone;
# K3, K4's plane and K11-K14), whose register budget sets three blocks an SM,
# and K5's d_plane pass (csrc/level_bwd.cu: the mark pass and the tile gather)
RUN_KERNELS = ("pool_runs", "pool_gather", "scatter_runs", "mark_cells", "cell_rows",
               "d_plane_tiles")
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
    log("build", f"ptxas registers/spill bytes: {ptxas_registers(info['log'])}; run "
        f"kernels {ptxas_registers(info['log'], RUN_KERNELS)}")
    return start_sass(info["path"], runtime.nvcc_path())


def start_sass(so_path: str, nvcc: str):
    """Start ``cuobjdump -sass`` of the built library (beside nvcc) into a
    temporary file, to run beside the kernel phase; ``check_sass`` waits for
    it and reads it."""
    import tempfile

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.NamedTemporaryFile("w", suffix=".sass", delete=False) as out:
        proc = subprocess.Popen([cuobjdump, "-sass", so_path], stdout=out,
                                stderr=subprocess.PIPE, text=True)
    return proc, out.name


def ptxas_registers(build_log: str, kernels=TENSOR_CORE_KERNELS) -> dict:
    """{kernel<template arguments>: "registers/spill bytes"} of ``kernels``
    (default the tensor-core ones), from nvcc's -Xptxas -v report; a bf16
    instance's arguments start with bf16."""
    import re

    regs, key, spill = {}, None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            key = next((k for k in kernels if k in name), None)
            if key:
                args = re.findall(r"L[ib](\d+)E", name[name.index(key):].split("Ev")[0])
                if "bfloat16" in name:
                    args = ["bf16"] + args
                key = f"{key}<{','.join(args)}>"
            spill = 0
        elif key and "spill stores" in line:
            spill = int(line.split("bytes stack frame,")[1].split("bytes spill stores")[0])
        elif key and "Used" in line and "registers" in line:
            regs[key] = f"{int(line.split('Used')[1].split('registers')[0])}/{spill}"
            key = None
    return regs


def check_sass(job) -> None:
    """Fail unless every kernel in TENSOR_CORE_KERNELS is in the built
    library's SASS (``start_sass``'s job) and every instance of each (each
    template instance in each source's cubin) holds its tensor-core
    instructions: for MMA_SYNC_KERNELS HMMA of its type, TF32, or BF16 in
    the bf16 instances (and then no TF32), each kernel with bf16 instances
    but F32_ONLY's; for WGMMA_KERNELS bf16 HGMMA and TMA loads (UTMALDG)."""
    proc, path = job
    _, err = proc.communicate(timeout=600)
    with open(path) as f:
        sass = f.read()
    os.remove(path)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}): {err[-2000:]}")
    # [key, symbol, its type, count of its type, count of another] per
    # instance; a wgmma kernel's type is "HGMMA", and the other count that of
    # its UTMALDG
    found, fn = [], None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            key = next((k for k in TENSOR_CORE_KERNELS if k in name), None)
            ty = ("HGMMA" if key in WGMMA_KERNELS else
                  "BF16" if "bfloat16" in name else "TF32")
            fn = [key, name, ty, 0, 0] if key else None
            if fn:
                found.append(fn)
        elif fn and fn[2] == "HGMMA":
            fn[3] += "HGMMA" in line and ".BF16" in line
            fn[4] += "UTMALDG" in line
        elif fn and "HMMA" in line:
            fn[3 if fn[2] in line else 4] += 1
    counts = {f"{k} {t}": [c for key, _, ty, c, _ in found if key == k and ty == t]
              for k in TENSOR_CORE_KERNELS for t in ("TF32", "BF16", "HGMMA")}
    tma = {k: [o for key, _, ty, _, o in found if key == k] for k in WGMMA_KERNELS}
    log("build", f"tensor-core instructions in the SASS, by kernel, type and instance: "
        f"{ {k: v for k, v in counts.items() if v} }; UTMALDG by instance {tma}")
    missing = ([k for k in TENSOR_CORE_KERNELS if not any(f[0] == k for f in found)]
               + [name for _, name, ty, c, other in found
                  if c == 0 or (other if ty != "HGMMA" else not other)]
               + [f"{k} BF16" for k in MMA_SYNC_KERNELS
                  if k not in F32_ONLY and not counts[f"{k} BF16"]])
    if missing:
        raise AssertionError(f"no tensor-core instructions of their type (bf16 HGMMA and "
                             f"UTMALDG in the wgmma kernels), or HMMA of another, in the "
                             f"SASS of {missing}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs between CUDA
    events, the host's work included: a whole forward (the kernel rows use
    ``graph_ms``)."""
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


# the one side stream on which graph_ms warms up and captures: cuBLAS keeps a
# workspace for every stream it has run on, for the life of the process
_CAPTURE: list = []


def graph_ms(fns, iters: int = 20, warmup: int = 2) -> float:
    """Median device milliseconds of one call, from CUDA graph replays: the
    call captured once in a CUDA graph, then replayed between two CUDA events
    as many times as last about a millisecond (at least once), ``iters``
    times. The card's queue stays full, so the host's launch overhead (a
    wrapper's checks and ctypes call, tens of microseconds) is left out.
    ``fns``: a callable, or a list of callables that compute one function
    each on its own copy of the inputs: the graph runs them in turn, so that
    inputs that fit in the L2 cache (50 MB) are not found there from the
    call before (in a model, other layers run in between), and the time is
    per call. A call that cannot be captured (one that waits on the card
    from the host) raises."""
    import torch

    fns = fns if isinstance(fns, list) else [fns]
    if not _CAPTURE:
        _CAPTURE.append(torch.cuda.Stream())
    side = _CAPTURE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            for fn in fns:
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for fn in fns:
            fn()

    def replays(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            graph.replay()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    replays(1)
    reps = max(1, min(100, int(1.0 / max(replays(1), 0.01))))
    return float(np.median([replays(reps) for _ in range(iters)])) / len(fns)


def bound(nbytes: float, ops):
    """(least ms the card could take, what bounds it) for a function that
    must move ``nbytes`` (inputs read once, outputs written once) and do
    ``ops``: a number of fp32 operations on the fp32-FMA route, or
    ``(flops, rate)`` pairs, one for each route the function's parts take
    (FP32_FLOP_S or TF32X3_FLOP_S)."""
    if not isinstance(ops, (list, tuple)):
        ops = [(ops, FP32_FLOP_S)]
    t_bytes, t_ops = nbytes / HBM_BYTES_S, sum(f / rate for f, rate in ops)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def flagship_batch(seed: int, b: int = 8, n: int = 16384, reso: int = 256,
                   tile_cells: int = 1024):
    """B patches of n uniform points (5% masked), unsorted and on the aligned
    layout with ``tile_cells``-cell tiles (points, mask, cells, tile offsets;
    trimmed as the loader does)."""
    from tomosar2height_tpu_torch.ops.sorted_scatter import (
        host_morton_bucket_aligned,
        trim_aligned_batch,
    )

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.001, 0.999, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > 0.05
    aligned = [host_morton_bucket_aligned(pts[i], mask[i], reso, tile_cells=tile_cells)
               for i in range(b)]
    apts, amask, acell, toff = trim_aligned_batch(*(
        np.stack([a[k] for a in aligned]) for k in ("points", "mask", "cells", "tile_offsets")))
    return pts, mask, apts, amask, acell, toff


def morton_rowmajor(code, reso: int):
    """Row-major index y * reso + x of Morton cell ids (x bits even, as
    csrc/common.cuh morton_to_rowmajor); numpy arrays or torch tensors."""
    def compact(v):
        v = v & 0x55555555
        v = (v | (v >> 1)) & 0x33333333
        v = (v | (v >> 2)) & 0x0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF
        return (v | (v >> 8)) & 0x0000FFFF

    return compact(code >> 1) * reso + compact(code)


def run_lengths(cells, ncell: int):
    """Lengths of the runs of one in-range cell id in each row of ``cells``
    (B, N): the run kernel's unit of work."""
    out = []
    for c in cells:
        ok = (c >= 0) & (c < ncell)
        heads = np.flatnonzero(ok & np.r_[True, c[1:] != c[:-1]])
        ends = np.flatnonzero(ok & np.r_[c[1:] != c[:-1], True]) + 1
        out.append(ends - heads)
    return np.concatenate(out)


def sorted_layout(pts, mask, reso: int = 256):
    """The plain sorted layout of a batch (the loader's for 'pallas' and
    'cumsum'): points and mask reordered, cells (pads reso**2), per-cell
    offsets."""
    from tomosar2height_tpu_torch.ops.sorted_scatter import host_morton_bucket

    spts, smask = np.empty_like(pts), np.empty_like(mask)
    cells = np.empty(mask.shape, np.int32)
    offs = np.empty((len(pts), reso * reso + 1), np.int32)
    for i in range(len(pts)):
        order, cells[i], offs[i] = host_morton_bucket(pts[i], mask[i], reso)
        spts[i], smask[i] = pts[i][order], mask[i][order]
    return spts, smask, cells, offs


# (reso, F, Fl) of the eight level round trips of the flagship forward
LEVEL_SHAPES = [(256, 32, 32), (256, 64, 32), (128, 128, 64), (64, 256, 128),
                (32, 512, 256), (64, 256, 512), (128, 128, 256), (256, 64, 128)]


def _xavier(gen, fan_in, fan_out, device):
    import torch

    a = (6.0 / (fan_in + fan_out)) ** 0.5
    return ((torch.rand(fan_in, fan_out, generator=gen, device=gen.device) * 2 - 1) * a).to(device)


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


ROUTES = {FP32_FLOP_S: "fp32 FMA", TF32X3_FLOP_S: "3xTF32", BF16_FLOP_S: "bf16"}
PLAIN_ITERS = 5  # graph_ms samples of a row's plain version and library call


def _entry_fn(rows):
    def entry(name, source, replaces, pairs, kfn, pfn, work, lfn=None,
              tol=f"{TOL:g} abs+rel", iters=20):
        """pairs: (kernel, plain[, atol, rtol]) tuples; kfn, pfn: the kernel
        and its plain version, each a callable or a list of callables on
        copies of the inputs (``graph_ms`` times both); work: (bytes, ops)
        the function needs on these inputs, ops as ``bound`` takes them;
        lfn: one PyTorch call computing the same function (timed as a
        yardstick), or None. A row with operations on the tensor cores also
        logs, for comparison, its bound were they all on fp32 FMA; a row
        timed on copies logs the kernel's time on one copy (its inputs warm
        in L2 from the replay before)."""
        errs = [_compare(*pair) for pair in pairs]
        err = max(e for e, _ in errs)
        ok = all(o for _, o in errs)
        # the plain version and the library call, slower and no row's
        # subject, on at most PLAIN_ITERS samples
        ms, plain_ms = graph_ms(kfn, iters), graph_ms(pfn, min(iters, PLAIN_ITERS))
        lib_ms = graph_ms(lfn, min(iters, PLAIN_ITERS)) if lfn is not None else None
        bound_ms, bound_by = bound(*work)
        ops = work[1] if isinstance(work[1], (list, tuple)) else [(work[1], FP32_FLOP_S)]
        flops = sum(f for f, _ in ops)
        route = " + ".join(f"{f / 1e12:.4f} TFLOP at {ROUTES[rate]}" for f, rate in ops)
        fp32 = ""
        if any(rate != FP32_FLOP_S for _, rate in ops):
            fp32 = f"; all on fp32 FMA {bound(work[0], flops)[0]:.4f} ms"
        if isinstance(kfn, list):
            fp32 += (f"; {len(kfn)} copies of the inputs in turn, the kernel on one copy "
                     f"{graph_ms(kfn[0], iters):.4f} ms")
        log("kernels", f"{name}: max|d| {err:.3g} (tol {tol}) "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms | bound "
            f"{bound_ms:.4f} ms ({bound_by}: {work[0] / 1e9:.3f} GB, {route}{fp32})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {err}")
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms}
        rows.append(row)
    return entry


def _explain_level(shape, ko, po, args):
    """Where K4 and its plain version disagree: log each one's distance from
    the plain version in float64, the worst c_out element, and whether a
    second kernel run gives the same c_out (ROADMAP C3)."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk

    plane, c_last, w, xy = args[:4]
    ref = lk.fused_level_plain(plane.double(), c_last.double(), tuple(t.double() for t in w),
                               xy.double(), *args[4:])
    again = lk.fused_level(*args)
    d = (ko[1].double() - ref[1]).abs()
    j = int(d.argmax())
    at = tuple(int(v) for v in torch.unravel_index(torch.tensor(j), d.shape))
    log("kernels", f"fused_level {shape} over tol; against float64: c_out kernel "
        f"{float(d.max()):.3g} plain {float((po[1].double() - ref[1]).abs().max()):.3g}, "
        f"plane kernel {float((ko[0].double() - ref[0]).abs().max()):.3g} plain "
        f"{float((po[0].double() - ref[0]).abs().max()):.3g}; worst c_out {at}: kernel "
        f"{float(ko[1].reshape(-1)[j]):.8g} plain {float(po[1].reshape(-1)[j]):.8g} "
        f"float64 {float(ref[1].reshape(-1)[j]):.8g}; rerun c_out equal "
        f"{torch.equal(again[1], ko[1])}, max|rerun - first| "
        f"{float((again[1] - ko[1]).abs().max()):.3g}")


# The bf16 rows' tolerances: the run kernels, K2, K5's d_plane pass and its
# weight sums within one bf16 ulp of their bf16 plain versions (f32 sums in
# two orders, each output rounded once; pool2's max exact); K4, K5 and K5's
# row pass under the JAX package's bf16 rule (tests/test_fused_level_bwd.py:
# 184-190), the f32 plain version on the same bf16 operands as the reference
ULP_RULE = "1 bf16 ulp of the plain version (floored at 2^-16 x scale)"
BF16_RULE = ("max(1.5 x the bf16 plain version's distance from the f32 plain version, "
             "0.02 x scale), from both")


def _ulp_tol(ref):
    """One bf16 ulp of each element of ``ref`` (2^-7 of the power of two at
    or below it), floored at 2^-16 of ref's scale where a sum cancels: an
    atol tensor for ``_compare``."""
    import torch

    r = ref.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.clamp_min(2.0 ** -126))) - 7)
    return ulp.clamp_min(2.0 ** -16 * float(r.max()))


def _bf16_rule_pairs(got, want, ref):
    """K4's and K5's bf16 rule: each kernel output no further from ``ref``
    (the f32 plain version on the same bf16 operands) than max(1.5x the bf16
    plain version's distance from it, 0.02 x scale), checked here, and as
    ``_compare`` pairs no further than that from the bf16 plain version
    ``want`` (so a row's max|d| is the kernel's distance from its plain
    version)."""
    pairs = []
    for g, w, r in zip(got, want, ref):
        g, w, r = g.float(), w.float(), r.float()
        bound = max(1.5 * float((w - r).abs().max()), 0.02 * float(r.abs().max()))
        far = float((g - r).abs().max())
        if far > bound:
            raise AssertionError(f"a bf16 kernel output lies {far} from its f32 plain "
                                 f"version, past {bound}")
        pairs.append((g, w, bound, 0.0))
    return pairs


def _upcast(args):
    """Arguments with every bf16 tensor (also inside tuples) in float32."""
    import torch

    def up(a):
        if isinstance(a, tuple):
            return tuple(up(x) for x in a)
        return a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
    return tuple(up(a) for a in args)


def check_kernels(seed: int = 0):
    """Each kernel against its plain version at the flagship shapes; K1-K5
    in f32, then in bf16."""
    import torch

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    _, _, apts, amask, acell, _ = flagship_batch(seed)
    b, npad = amask.shape
    reso = 256
    gen = torch.Generator(device=dev).manual_seed(seed)  # inputs drawn on the card
    xy = torch.from_numpy(apts[..., :2]).to(dev).contiguous()
    mask = torch.from_numpy(amask).to(dev)
    cells = torch.from_numpy(acell).to(dev)
    log("kernels", f"B={b} Npad={npad} valid={int(amask.sum())} reso={reso}")
    rows = []
    entry = _entry_fn(rows)
    runs = run_lengths(acell, reso * reso)
    log("kernels", f"pool2 runs at the flagship shapes: {runs.size} runs, largest "
        f"{int(runs.max())} rows, mean {runs.mean():.3f}, {int((runs > 32).sum())} longer "
        f"than a warp's 32-row span")
    level_args = {}
    for dt in (torch.float32, torch.bfloat16):
        _pool_rows(entry, dt, cells, mask, reso, gen)
        level_args[dt] = _level_rows(entry, dt, xy, cells, mask, reso, gen)
        torch.cuda.synchronize()
        log("time", f"kernels: K1-K5 in {dt} done at {time.perf_counter() - t_start:.1f} s")
    for part, fn, args in (("C3 stress", stress_level, (level_args[torch.float32],)),
                           ("C3 stress in bf16", stress_level, (level_args[torch.bfloat16],)),
                           ("depth-6 level", check_wide_level, (seed,)),
                           ("K6-K8", check_conv_kernels, (entry, seed)),
                           ("K6-K8 in bf16", check_conv_kernels_bf16, (entry, seed)),
                           ("K9-K14 and the fused backwards", check_tile_kernels,
                            (entry, seed)),
                           ("K9-K14 and the fused backwards in bf16", check_tile_kernels,
                            (entry, seed, torch.bfloat16))):
        fn(*args)
        log("time", f"kernels: {part} done at {time.perf_counter() - t_start:.1f} s")
    # free the cuBLAS workspace of graph_ms's stream (32 MiB), so that the
    # later phases' peak memory holds what the parent's does
    torch._C._cuda_clearCublasWorkspaces()
    return rows


def _pool_rows(entry, dt, cells, mask, reso: int, gen):
    """The rows of pool2.cu in ``dt`` (float32, or bfloat16: rows named
    ``*_bf16``) at the flagship shapes, on random values with F = 32: pool2
    on the run kernel (K1 + K2 in one launch; max exact, mean and sum within
    TOL or ULP_RULE), K3 on the run scatter (counts exact), pool2's backward
    (max and mean) and K2 alone (scatter_plane2's backward), each run twice
    and held bit-equal, each timed on three copies of its inputs in turn
    (one copy, ~40 MB in f32, would stay in the 50 MB L2 between replays),
    beside one library call of the same function."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk

    dev = mask.device
    b, npad = mask.shape
    f32 = dt == torch.float32
    sfx = "" if f32 else "_bf16"
    ncell = reso * reso
    nf = 32
    vals = (torch.randn(b, npad, nf, generator=gen, device=dev) * mask[..., None]).to(dt)
    arange_b = torch.arange(b, device=dev)[:, None]

    def close(got, want):
        """A pair held to TOL (f32) or to one bf16 ulp."""
        return (got, want) if f32 else (got.float(), want.float(), _ulp_tol(want), 0.0)

    def flat_cells(c, m):
        """The library yardsticks' index into the flat (B * ncell) cells;
        rows that are not valid go to one spare row."""
        return torch.where(m & (c >= 0), c + ncell * arange_b,
                           torch.full_like(c, b * ncell)).reshape(-1).long()

    def pooled_by_library(src, reduce, flat):
        """scatter_reduce into the flat cells, then index_select back to the
        rows: K1's and K2's library yardsticks in turn."""
        cellv = torch.zeros(b * ncell + 1, nf, device=dev, dtype=dt).scatter_reduce_(
            0, flat[:, None].expand(-1, nf), src.reshape(-1, nf), reduce, include_self=False)
        return cellv.index_select(0, flat)

    g = torch.randn(vals.shape, generator=gen, device=dev).to(dt)
    g_plane = torch.randn(b, reso, reso, nf, generator=gen, device=dev).to(dt)
    sets = [{"v": vals, "c": cells, "m": mask, "g": g, "gp": g_plane}]
    sets += [{k: t.clone() for k, t in sets[0].items()} for _ in range(2)]
    for s in sets:
        s["flat"] = flat_cells(s["c"], s["m"])
    valid_rows = int((mask & (cells >= 0) & (cells < ncell)).sum())

    def on_valid_rows(*tensors):
        """Bytes of the valid rows of (B, Npad, ...) tensors: a per-row input
        that the run kernel, K2 and K3 read only there."""
        return nbytes(*tensors) * valid_rows // (b * npad)

    # pool2 on the run kernel; each kind twice, bit-equal. Bytes: values on
    # the valid rows, cells and mask read, out written
    fwd = {k: pk.pool2_fwd(vals, cells, mask, reso, k) for k in ("max", "mean", "sum")}
    repeat = all(torch.equal(pk.pool2_fwd(vals, cells, mask, reso, k), v) for k, v in fwd.items())
    fwd_bytes = on_valid_rows(vals) + nbytes(cells, mask, fwd["max"])
    want = {k: pk.pool2_plain(vals, cells, mask, reso, k) for k in fwd}
    for name, kind, lib, pairs, tol in (
            ("pool2", "max", "amax", [(fwd["max"], want["max"], 0.0, 0.0)], "exact"),
            ("pool2_mean", "mean", "mean", [close(fwd[k], want[k]) for k in ("mean", "sum")],
             f"{TOL:g} abs+rel, mean and sum" if f32 else f"{ULP_RULE}, mean and sum")):
        entry(name + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
              "tomosar2height_tpu/ops/pallas/pool2_kernel.py:46", pairs,
              [lambda s=s, k=kind: pk.pool2_fwd(s["v"], s["c"], s["m"], reso, k) for s in sets],
              [lambda s=s, k=kind: pk.pool2_plain(s["v"], s["c"], s["m"], reso, k)
               for s in sets],
              (fwd_bytes, vals.numel()),
              [lambda s=s, r=lib: pooled_by_library(s["v"], r, s["flat"]) for s in sets],
              tol=tol)
    del want
    # K3 on the run scatter: counts exact, the plane within TOL (one bf16
    # ulp), and a second launch bit-equal. Bytes: values on the valid rows,
    # cells and mask read, the plane and counts written once
    kp, kc = pk.scatter_plane2(vals, cells, mask, reso)
    pp, pc = pk.scatter_plane2_plain(vals, cells, mask, reso)
    if not torch.equal(kc, pc):
        raise AssertionError(f"scatter_plane2{sfx} counts differ")
    again = pk.scatter_plane2(vals, cells, mask, reso)
    k3_repeat = torch.equal(kp, again[0]) and torch.equal(kc, again[1])
    log("kernels", f"scatter_plane2{sfx} bit-equal on a second launch: {k3_repeat}; occupied "
        f"cells {int((kc > 0).sum())} of {kc.numel()}")
    if not k3_repeat:
        raise AssertionError(f"scatter_plane2{sfx} differs between two launches")
    del again
    entry("scatter_plane2" + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:263", [close(kp, pp)],
          [lambda s=s: pk.scatter_plane2(s["v"], s["c"], s["m"], reso) for s in sets],
          [lambda s=s: pk.scatter_plane2_plain(s["v"], s["c"], s["m"], reso) for s in sets],
          (on_valid_rows(vals) + nbytes(cells, mask, kp, kc), vals.numel()),
          [lambda s=s: torch.zeros(b * ncell + 1, nf, device=dev, dtype=dt).scatter_reduce_(
              0, s["flat"][:, None].expand(-1, nf), s["v"].reshape(-1, nf), "mean",
              include_self=False) for s in sets],
          tol=f"{TOL:g} abs+rel" if f32 else ULP_RULE)

    # pool2's backward on the run kernel (max: the run sum of g gated by
    # values == out; mean: the run mean of g), twice each, bit-equal; and
    # scatter_plane2's on K2
    pairs, moved = [], 0
    for s in sets:
        s["out"] = {k: fwd[k].clone() for k in ("max", "mean")}
    for kind in ("max", "mean"):
        a = (g, vals, fwd[kind], cells, mask, reso, kind)
        dv = pk.pool2_bwd(*a)
        pairs.append(close(dv, pk.pool2_bwd_plain(*a)))
        repeat = repeat and torch.equal(dv, pk.pool2_bwd(*a))
        # g on the valid rows (and values, out there for max's gate), cells
        # and mask read, dv written
        moved += (on_valid_rows(g, *((vals, fwd[kind]) if kind == "max" else ()))
                  + nbytes(cells, mask, dv))

    def bwd_args(s):
        return [(s["g"], s["v"], s["out"][k], s["c"], s["m"], reso, k) for k in ("max", "mean")]

    def bwd_by_library(s):
        cell_sum = pooled_by_library(s["g"], "sum", s["flat"]).reshape(vals.shape)
        return (torch.where(s["v"] == s["out"]["max"], cell_sum, 0),
                pooled_by_library(s["g"], "mean", s["flat"]))

    entry("pool2_bwd" + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:492", pairs,
          [lambda s=s: [pk.pool2_bwd(*a) for a in bwd_args(s)] for s in sets],
          [lambda s=s: [pk.pool2_bwd_plain(*a) for a in bwd_args(s)] for s in sets],
          (moved, 2 * vals.numel()), [lambda s=s: bwd_by_library(s) for s in sets],
          tol=f"{TOL:g} abs+rel" if f32 else ULP_RULE)
    log("kernels", f"pool2{sfx} forward and backward bit-equal run to run: {repeat}")
    if not repeat:
        raise AssertionError(f"pool2{sfx}'s run kernel differs between two runs")
    # K2 reads the plane and the counts only at the cells that hold a valid row
    occupied = int((kc > 0).sum())
    for s in sets:
        s["kc"] = kc.clone()
        # the library yardstick: one index_select of the row-major plane (a
        # zero row appended for the rows that are not valid) and one of the
        # counts, then the division
        ok = s["m"] & (s["c"] >= 0) & (s["c"] < ncell)
        rm = morton_rowmajor(torch.where(ok, s["c"], 0), reso) + ncell * arange_b
        s["rm"] = torch.where(ok, rm, torch.full_like(rm, b * ncell)).reshape(-1)
        s["gp_pad"] = torch.cat([s["gp"].reshape(-1, nf),
                                 torch.zeros(1, nf, device=dev, dtype=dt)])
        s["kc_pad"] = torch.cat([s["kc"].reshape(-1), torch.ones(1, device=dev,
                                                                  dtype=torch.int32)])
    # K2 alone, held bit-equal on a second launch
    a = (g_plane, cells, mask, kc)
    k2 = pk.scatter_plane2_bwd(*a)
    k2_repeat = torch.equal(k2, pk.scatter_plane2_bwd(*a))
    log("kernels", f"scatter_plane2_bwd{sfx} bit-equal on a second launch: {k2_repeat}")
    if not k2_repeat:
        raise AssertionError(f"scatter_plane2_bwd{sfx} differs between two launches")
    entry("scatter_plane2_bwd" + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/pool2_kernel.py:133",
          [close(k2, pk.scatter_plane2_bwd_plain(*a))],
          [lambda s=s: pk.scatter_plane2_bwd(s["gp"], s["c"], s["m"], s["kc"]) for s in sets],
          [lambda s=s: pk.scatter_plane2_bwd_plain(s["gp"], s["c"], s["m"], s["kc"])
           for s in sets],
          ((nbytes(g_plane, kc) * occupied // kc.numel() + nbytes(cells, mask, vals)),
           vals.numel()),
          [lambda s=s: s["gp_pad"].index_select(0, s["rm"])
           / s["kc_pad"].index_select(0, s["rm"]).clamp_min(1)[:, None] for s in sets],
          tol=f"{TOL:g} abs+rel" if f32 else ULP_RULE)


def _level_rows(entry, dt, xy, cells, mask, reso: int, gen):
    """K4 and K5 in ``dt`` (float32 on 3xTF32, or bfloat16 on one bf16
    pass: rows named ``*_bf16``) at the eight flagship levels (LEVEL_SHAPES):
    K4 (plane and c_out, counts exact), K5 on random output cotangents on the
    rows off the ReLU kink (KINK) and each of its parts (the row pass, the
    d_plane pass on the kernel's d_s, the weight sums on random rows) a row
    of its own; f32 at TOL, BWD_TOL and the weight tolerance, bf16 at
    BF16_RULE (the d_plane pass and weight sums at ULP_RULE); every one
    bit-equal on a second launch. Returns K4's arguments at each level."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk

    dev = mask.device
    b, npad = mask.shape
    f32 = dt == torch.float32
    sfx = "" if f32 else "_bf16"
    rate = TF32X3_FLOP_S if f32 else BF16_FLOP_S
    pairs, kfns, pfns = [], [], []
    bwd_pairs, bwd_k, bwd_p, red_pairs, red_k, red_p = [], [], [], [], [], []
    red_l, rows_pairs, rows_k, rows_p, red_by_shape = [], [], [], [], []
    dp_pairs, dp_k, dp_p, dp_l, level_args = [], [], [], [], []
    # bytes, then operations on the route's tensor cores: K4's; K5's (its
    # row pass, then its weight sums); the row pass alone; the reductions
    # alone; and the d_plane pass's bytes and fp32 operations
    work = {"level": [0, 0], "bwd": [0, 0, 0], "rows": [0, 0], "reduce": [0, 0],
            "d_plane": [0, 0]}
    valid = int(mask.sum())
    for r, f, fl in LEVEL_SHAPES:
        plane = torch.randn(b, r, r, f, generator=gen, device=dev).to(dt)
        c_last = (torch.randn(b, npad, fl, generator=gen, device=dev) * mask[..., None]).to(dt)
        w = tuple(x.to(dt) for x in (
            _xavier(gen, f, 2 * f, dev), torch.zeros(2 * f, device=dev),
            _xavier(gen, 2 * f, f, dev), torch.zeros(f, device=dev),
            _xavier(gen, fl, f, dev), torch.zeros(f, device=dev)))
        args = (plane, c_last, w, xy, cells, mask, r, reso)
        level_args.append(args)
        ko = lk.fused_level(*args)
        po = lk.fused_level_plain(*args)
        if not torch.equal(ko[2], po[2]):
            raise AssertionError(f"fused_level{sfx} counts differ at {(r, f, fl)}")
        # K4's plane on the run scatter: plane, c_out and counts bit-equal on
        # a second launch
        if not all(torch.equal(x, y) for x, y in zip(lk.fused_level(*args), ko)):
            raise AssertionError(f"fused_level{sfx} differs between two launches at "
                                 f"{(r, f, fl)}")
        if f32:
            level_pairs = [(ko[0], po[0]), (ko[1], po[1])]
            if not all(_compare(*pair)[1] for pair in level_pairs):
                _explain_level((r, f, fl), ko, po, args)
        else:
            level_pairs = _bf16_rule_pairs(ko[:2], po[:2],
                                           lk.fused_level_plain(*_upcast(args))[:2])
        e_fwd = max(_compare(*pair)[0] for pair in level_pairs)
        pairs += level_pairs
        work["level"][0] += nbytes(plane, c_last, xy, cells, mask, *w, *ko)
        work["level"][1] += 2 * valid * (4 * f * f + f * fl)
        kfns.append(lambda a=args: lk.fused_level(*a))
        pfns.append(lambda a=args: lk.fused_level_plain(*a))
        # K5 on random output cotangents, rows off the ReLU kink (KINK), with
        # the counts of the forward on those rows
        pre = lk.mm(lk.level_sample(plane, xy), w[0]) + w[1]
        mask5 = mask & ~(pre.abs() < KINK).any(-1)
        del pre
        counts5 = lk.fused_level(plane, c_last, w, xy, cells, mask5, r, reso)[2]
        g_p = torch.randn(b, r, r, f, generator=gen, device=dev).to(dt)
        g_c = torch.randn(b, npad, f, generator=gen, device=dev).to(dt)
        bargs = (plane, c_last, w, xy, cells, mask5, counts5, g_p, g_c, r, reso)
        kb, pb = lk.fused_level_bwd(*bargs), lk.fused_level_bwd_plain(*bargs)
        flat_kb, flat_pb = list(kb[:2]) + list(kb[2]), list(pb[:2]) + list(pb[2])
        again = lk.fused_level_bwd(*bargs)
        if not all(torch.equal(x, y) for x, y in zip(list(again[:2]) + list(again[2]),
                                                     flat_kb)):
            raise AssertionError(f"fused_level_bwd{sfx} differs between two launches at "
                                 f"{(r, f, fl)}")
        del again
        if f32:
            level_pairs = [(kb[0], pb[0], *BWD_TOL), (kb[1], pb[1], *BWD_TOL)]
            level_pairs += [(x, y, *_weight_tol(y)) for x, y in zip(kb[2], pb[2])]
        else:
            ref = lk.fused_level_bwd_plain(*_upcast(bargs))
            level_pairs = _bf16_rule_pairs(flat_kb, flat_pb, list(ref[:2]) + list(ref[2]))
            del ref
        bwd_pairs += level_pairs
        work["bwd"][0] += nbytes(plane, c_last, xy, cells, mask5, counts5, g_p, g_c, *w,
                                 *flat_kb)
        work["bwd"][1] += 2 * int(mask5.sum()) * (6 * f * f + f * fl)
        work["bwd"][2] += 2 * int(mask5.sum()) * (4 * f * f + f * fl)
        # the row pass alone: d_c_last, and its scratch rows on the rows it
        # computes (f32: s and h at K4's tolerance, d_o exact up to the
        # count's division, d_h and d_s at K5's)
        kr, pr = lk.fused_level_bwd_rows(*bargs), lk.fused_level_bwd_rows_plain(*bargs)
        v5 = mask5.reshape(-1)
        if f32:
            rows_pairs += [(kr[0], pr[0], *BWD_TOL)]
            rows_pairs += [(k[v5], p[v5], *tol) for k, p, tol in zip(
                kr[1:], pr[1:], ((TOL, TOL), (TOL, TOL), (TOL, TOL), BWD_TOL, BWD_TOL))]
        else:
            ref = lk.fused_level_bwd_rows_plain(*_upcast(bargs))
            rows_pairs += _bf16_rule_pairs(
                [kr[0]] + [k[v5] for k in kr[1:]], [pr[0]] + [p[v5] for p in pr[1:]],
                [ref[0]] + [x[v5] for x in ref[1:]])
            del ref
        work["rows"][0] += nbytes(plane, xy, cells, mask5, counts5, g_p, g_c, w[0], w[1], w[2],
                                  w[4], *kr)
        work["rows"][1] += 2 * int(mask5.sum()) * (6 * f * f + f * fl)
        rows_k.append(lambda a=bargs: lk.fused_level_bwd_rows(*a))
        rows_p.append(lambda a=bargs: lk.fused_level_bwd_rows_plain(*a))
        # the d_plane pass on the kernel's d_s: held to the plain transpose
        # of the same d_s, bit-equal on a second launch. Bytes: d_s and xy on
        # the valid rows, every row's cell id and mask, the finest cells' row
        # ranges written and read, d_plane written once; operations: a
        # multiply-add a corner and feature. Yardstick: the d_input of
        # F.grid_sample's backward on the same rows
        d_s = kr[-1].view(b, npad, f)
        dargs = (d_s, xy, cells, mask5, r, reso)
        kd, pd = lk.level_d_plane(*dargs), lk.level_d_plane_plain(*dargs)
        if not torch.equal(lk.level_d_plane(*dargs), kd):
            raise AssertionError(f"level_d_plane{sfx} differs between two launches at "
                                 f"{(r, f)}")
        dp_pairs.append((kd, pd, *BWD_TOL) if f32 else
                        (kd.float(), pd.float(), _ulp_tol(pd), 0.0))
        n5 = int(mask5.sum())
        work["d_plane"][0] += (n5 * (f * d_s.element_size() + 8) + nbytes(cells, mask5, kd)
                               + 2 * 2 * b * reso * reso * 4)
        work["d_plane"][1] += 2 * 4 * n5 * f
        dp_k.append(lambda a=dargs: lk.level_d_plane(*a))
        dp_p.append(lambda a=dargs: lk.level_d_plane_plain(*a))
        gin = plane.permute(0, 3, 1, 2).contiguous()
        gout = d_s.permute(0, 2, 1)[..., None].contiguous()
        grid = (2 * xy - 1)[:, :, None, :].to(dt).contiguous()
        dp_l.append(lambda a=(gout, gin, grid): torch.ops.aten.grid_sampler_2d_backward(
            *a, 0, 1, True, [True, False])[0])
        del kr, pr, pd
        ed = max(_compare(*pair)[0] for pair in level_pairs)
        log("kernels", f"fused_level{sfx} R={r} F={f} Fl={fl}: max|d| forward {e_fwd:.3g} "
            f"| backward {ed:.3g} on {int(mask5.sum())} of {valid} rows (the rest within "
            f"{KINK:g} of the ReLU kink)")
        bwd_k.append(lambda a=bargs: lk.fused_level_bwd(*a))
        bwd_p.append(lambda a=bargs: lk.fused_level_bwd_plain(*a))
        # K5's reductions alone, on random rows of this level's shapes
        m = b * npad
        for ka, nb, bias in ((f, 2 * f, True), (2 * f, f, True), (fl, f, False)):
            ra = torch.randn(m, ka, generator=gen, device=dev).to(dt)
            rb = torch.randn(m, nb, generator=gen, device=dev).to(dt)
            kr = lk.level_bwd_reduce(ra, rb, bias)
            pr = lk.level_bwd_reduce_plain(ra, rb, bias)
            red_pairs += [(x, y, *_weight_tol(y)) if f32 else
                          (x.float(), y.float(), _ulp_tol(y).max(), 0.0)
                          for x, y in zip(kr, pr) if y is not None]
            if not f32:
                red_by_shape.append(_reduce_shape((ra, rb, bias), kr, pr))
            work["reduce"][0] += nbytes(ra, rb, *kr)
            work["reduce"][1] += 2 * m * ka * nb
            red_l.append(lambda a=(ra, rb): torch.matmul(a[0].t(), a[1]))
            red_k.append(lambda a=(ra, rb, bias): lk.level_bwd_reduce(*a))
            red_p.append(lambda a=(ra, rb, bias): lk.level_bwd_reduce_plain(*a))
    entry("fused_level" + sfx, "tomosar2height_tpu_torch/csrc/"
          + ("level.cu" if f32 else "level_bf16.cu"),
          "tomosar2height_tpu/ops/pallas/level_kernel.py:110", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns],
          (work["level"][0], [(work["level"][1], rate)]),
          tol=f"{TOL:g} abs+rel" if f32 else BF16_RULE)
    if not f32:
        _level_by_shape(kfns)
    bwd_tol = (f"{BWD_TOL[0]:g} abs + {BWD_TOL[1]:g} rel; weights "
               f"{WEIGHT_RTOL:g}*max|ref| abs + {WEIGHT_RTOL:g} rel") if f32 else BF16_RULE
    entry("fused_level_bwd" + sfx, "tomosar2height_tpu_torch/csrc/level_bwd.cu",
          "tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:68", bwd_pairs,
          lambda: [fn() for fn in bwd_k], lambda: [fn() for fn in bwd_p],
          (work["bwd"][0], [(work["bwd"][1], rate), (work["bwd"][2], rate)]),
          tol=bwd_tol)
    entry("fused_level_bwd_rows" + sfx, "tomosar2height_tpu_torch/csrc/"
          + ("level_bwd.cu" if f32 else "level_bwd_bf16.cu"),
          "tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:68", rows_pairs,
          lambda: [fn() for fn in rows_k], lambda: [fn() for fn in rows_p],
          (work["rows"][0], [(work["rows"][1], rate)]),
          tol=(f"{BWD_TOL[0]:g} abs + {BWD_TOL[1]:g} rel; s, h, d_o {TOL:g} abs+rel" if f32
               else BF16_RULE))
    if red_by_shape:
        log("kernels", "level_bwd_reduce_bf16 by (Ka x Nb, +b with the bias): kernel / "
            "torch.matmul ms (graph replays, median of 5), the distance of the kernel and "
            "of its plain version from the float64 product in bf16 ulps of the scale: "
            + "; ".join(red_by_shape))
    entry("level_bwd_reduce" + sfx, "tomosar2height_tpu_torch/csrc/"
          + ("level_bwd.cu" if f32 else "reduce_bf16.cu"),
          "tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:260", red_pairs,
          lambda: [fn() for fn in red_k], lambda: [fn() for fn in red_p],
          (work["reduce"][0], [(work["reduce"][1], rate)]),
          lambda: [fn() for fn in red_l],
          tol=(f"{WEIGHT_RTOL:g}*max|ref| abs + {WEIGHT_RTOL:g} rel" if f32 else
               "1 bf16 ulp of the plain version's scale"))
    entry("level_d_plane" + sfx, "tomosar2height_tpu_torch/csrc/level_bwd.cu",
          "tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:68", dp_pairs,
          lambda: [fn() for fn in dp_k], lambda: [fn() for fn in dp_p],
          tuple(work["d_plane"]), lambda: [fn() for fn in dp_l],
          tol=f"{BWD_TOL[0]:g} abs + {BWD_TOL[1]:g} rel" if f32 else ULP_RULE)
    log("kernels", f"K4{sfx} (plane, c_out, counts), K5{sfx} (d_plane, d_c_last, weights) and "
        f"its d_plane pass bit-equal on a second launch at every level: True")
    return level_args


def _level_by_shape(kfns) -> None:
    """K4 bf16 at each of LEVEL_SHAPES (``kfns``: its calls, K4 and its run
    scatter, as the row times them): graph replays, median of 5, with the
    plan each level takes (``tile_plan.level_plan``: rows a block, o's
    columns split between the warpgroups or not, the ring's stages) and its
    launches by route (one route: every width on csrc/level_bf16.cu)."""
    from tomosar2height_tpu_torch.ops.cuda import runtime, tile_plan

    before = runtime.LAUNCHES["fused_level_bf16"]
    for fn in kfns:
        fn()
    launched = runtime.LAUNCHES["fused_level_bf16"] - before
    per = []
    for (r, f, fl), fn in zip(LEVEL_SHAPES, kfns):
        p = tile_plan.level_plan(f, fl)
        per.append(f"{r}/{f}/{fl} {graph_ms(fn, 5):.4f} ({p['bm']} rows, "
                   f"{'cols split' if p['cols'] else 'rows split'}, {p['stages']} stages)")
    log("kernels", "fused_level_bf16 by level (R/F/Fl: K4 + its run scatter ms, graph "
        "replays, median of 5; the plan): " + "; ".join(per) + f"; launches by route: wgmma "
        f"{launched} of {len(kfns)} calls")


def _reduce_shape(args, got, want) -> str:
    """One bf16 weight sum (``args``: a, b, bias; ``got`` the kernel's,
    ``want`` the plain version's outputs): its kernel and ``torch.matmul``
    times (graph replays, median of 5) and the distance of each from the
    float64 product over all rows, in bf16 ulps of the output's scale: the
    check of the wgmma chains' truncation (csrc/reduce_bf16.cu) at the
    flagship's M."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk

    a, b, bias = args
    refs = (a.double().t() @ b.double(), b.double().sum(0) if bias else None)
    ulps = []
    for out in (got, want):
        worst = 0.0
        for x, r in zip(out, refs):
            if r is not None:
                ulp = 2.0 ** (float(torch.floor(torch.log2(r.abs().max()))) - 7)
                worst = max(worst, float((x.double() - r).abs().max()) / ulp)
        ulps.append(worst)
    ms = graph_ms(lambda: lk.level_bwd_reduce(*args), 5)
    lib = graph_ms(lambda: torch.matmul(a.t(), b), 5)
    return (f"{a.shape[1]}x{b.shape[1]}{'+b' if bias else ''} {ms:.4f} / {lib:.4f} ms, "
            f"{ulps[0]:.3f} / {ulps[1]:.3f} ulp")


STRESS_LAUNCHES = 200


def stress_level(level_args):
    """K4's rare disagreement with its plain version (ROADMAP: K4 stress
    check): K4 at every flagship level (``level_args``: its arguments
    at each of LEVEL_SHAPES, f32 or bf16), STRESS_LAUNCHES launches each,
    every one bit-equal (plane, c_out, counts) to the first, which is within
    TOL (bf16: BF16_RULE) of the plain version. On an f32 failure
    ``_explain_level`` logs both sides' distance from float64, then the
    smoke fails."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk

    t0 = time.perf_counter()
    f32 = level_args[0][0].dtype == torch.float32
    for shape, args in zip(LEVEL_SHAPES, level_args):
        first, po = lk.fused_level(*args), lk.fused_level_plain(*args)
        pairs = ([(first[0], po[0]), (first[1], po[1])] if f32 else
                 _bf16_rule_pairs(first[:2], po[:2], lk.fused_level_plain(*_upcast(args))[:2]))
        ok = all(_compare(*pair)[1] for pair in pairs)
        bad = 0
        for _ in range(STRESS_LAUNCHES - 1):
            again = lk.fused_level(*args)
            bad += not all(torch.equal(x, y) for x, y in zip(again, first))
        if not ok or bad:
            if f32:
                _explain_level(shape, first, po, args)
            raise AssertionError(f"fused_level {shape} {args[0].dtype}: within its tolerance "
                                 f"of plain {ok}, {bad} of {STRESS_LAUNCHES - 1} launches "
                                 f"differ from the first")
        del first, po, pairs
    log("kernels", f"C3 stress{'' if f32 else ' (bf16)'}: K4 at the {len(level_args)} levels, "
        f"{STRESS_LAUNCHES} launches each: every launch bit-equal to the first, the first "
        f"within {f'{TOL:g}' if f32 else BF16_RULE} of plain ({time.perf_counter() - t0:.1f} "
        f"s)")


def check_wide_level(seed: int = 0):
    """K4 and K5 at the first up level of a depth-6 U-Net, (R, F, Fl) =
    (32, 512, 1024), at the flagship shapes: c_last is contracted in 512-row
    K-chunks (logged beside the kernel table, not in K4's row); then K4 in
    bf16 on the same inputs rounded to bf16, under BF16_RULE and bit-equal on
    a second launch (its c_last in 32 boxes of 32 columns)."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
    from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d

    dev = torch.device(DEVICE)
    _, _, apts, amask, acell, _ = flagship_batch(seed + 3)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    xy = torch.from_numpy(apts[..., :2]).to(dev).contiguous()
    mask = torch.from_numpy(amask).to(dev)
    cells = torch.from_numpy(acell).to(dev)
    b, npad = amask.shape
    r, f, fl = 32, 512, 1024
    plane = torch.randn(b, r, r, f, generator=gen, device=dev)
    c_last = (torch.randn(b, npad, fl, generator=gen, device=dev) * mask[..., None]).contiguous()
    w = (_xavier(gen, f, 2 * f, dev), torch.zeros(2 * f, device=dev),
         _xavier(gen, 2 * f, f, dev), torch.zeros(f, device=dev),
         _xavier(gen, fl, f, dev), torch.zeros(f, device=dev))
    args = (plane, c_last, w, xy, cells, mask, r, 256)
    ko, po = lk.fused_level(*args), lk.fused_level_plain(*args)
    pre = grid_sample_2d(plane, xy) @ w[0] + w[1]
    mask5 = mask & ~(pre.abs() < KINK).any(-1)
    del pre
    counts5 = lk.fused_level(plane, c_last, w, xy, cells, mask5, r, 256)[2]
    g_p = torch.randn(b, r, r, f, generator=gen, device=dev)
    g_c = torch.randn(b, npad, f, generator=gen, device=dev)
    bargs = (plane, c_last, w, xy, cells, mask5, counts5, g_p, g_c, r, 256)
    kb, pb = lk.fused_level_bwd(*bargs), lk.fused_level_bwd_plain(*bargs)
    fwd = [_compare(ko[0], po[0]), _compare(ko[1], po[1])]
    bwd = [_compare(kb[0], pb[0], *BWD_TOL), _compare(kb[1], pb[1], *BWD_TOL)]
    bwd += [_compare(x, y, *_weight_tol(y)) for x, y in zip(kb[2], pb[2])]
    ok = torch.equal(ko[2], po[2]) and all(o for _, o in fwd + bwd)
    ms = graph_ms(lambda: lk.fused_level(*args), iters=10)
    bwd_ms = graph_ms(lambda: lk.fused_level_bwd(*bargs), iters=5)
    log("kernels", f"fused_level R={r} F={f} Fl={fl} (depth-6 up level): forward max|d| "
        f"{max(e for e, _ in fwd):.3g} (tol {TOL:g}), {ms:.3f} ms | backward max|d| "
        f"{max(e for e, _ in bwd):.3g} on {int(mask5.sum())} of {int(mask.sum())} rows, "
        f"{bwd_ms:.3f} ms | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K4/K5 disagree with their plain versions at Fl=1024")
    del kb, pb, bargs, ko, po
    bf = (plane.bfloat16(), c_last.bfloat16(), tuple(x.bfloat16() for x in w), *args[3:])
    ko = lk.fused_level(*bf)
    pairs = _bf16_rule_pairs(ko[:2], lk.fused_level_plain(*bf)[:2],
                             lk.fused_level_plain(*_upcast(bf))[:2])
    again = all(torch.equal(x, y) for x, y in zip(lk.fused_level(*bf), ko))
    ms = graph_ms(lambda: lk.fused_level(*bf), iters=10)
    log("kernels", f"fused_level_bf16 R={r} F={f} Fl={fl} (depth-6 up level): max|d| "
        f"{max(_compare(*p)[0] for p in pairs):.3g} ({BF16_RULE}), bit-equal on a second "
        f"launch {again}, {ms:.3f} ms")
    if not (again and all(_compare(*p)[1] for p in pairs)):
        raise AssertionError("K4 bf16 disagrees with its plain version at Fl=1024")


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


def _held_to_float64(name, got, want, plain_fn, args):
    """[(kernel output, the plain version's in float64)]: a conv kernel is
    held at TOL to its plain version run in float64 on the same inputs,
    since the fp32 plain version (cuDNN) is itself up to 2.1e-5 off float64
    at K = 9 * 1024 (32^2, 1024 -> 512). got and want (the fp32 plain
    outputs) are tensors or tuples of them (None skipped); where got and
    want differ by more than TOL, log each one's distance from float64."""
    ref = plain_fn(*(a.double() for a in args))
    pairs = []
    for g, w, r in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, want, ref))):
        if g is None:
            continue
        err, ok = _compare(g, w)
        if not ok:
            log("kernels", f"{name}: max|d| {err:.3g} from fp32 plain, over tol; against "
                f"float64: kernel {float((g.double() - r).abs().max()):.3g}, fp32 plain "
                f"{float((w.double() - r).abs().max()):.3g}")
        pairs.append((g, r))
    return pairs


def check_conv_kernels(entry, seed: int = 0):
    """K8 at the 43 convs, K7 at the 20 pairs and K6 at the decoder of a
    batch-8 fusion forward, each held to its plain version run in float64
    (``_held_to_float64``) and timed beside the fp32 plain version; K8 also
    beside one ``F.conv2d`` (cuDNN, full fp32) per conv. (The per-shape
    times of K8 and K7 are ``tools/time_conv_pair.py``'s.)"""
    import torch
    import torch.nn.functional as F

    from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
    from tomosar2height_tpu_torch.ops.cuda import convpair_kernel as cpk
    from tomosar2height_tpu_torch.ops.cuda import decoder_kernel as dk

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 7)
    xgen = torch.Generator(device=dev).manual_seed(seed + 7)  # inputs drawn on the card
    b = 8
    x_of = lambda h, c: torch.randn(b, h, h, c, generator=xgen, device=dev)  # noqa: E731

    pairs, kfns, pfns, lfns, work = [], [], [], [], [0, 0]
    for h, cin, cout in CONVS:
        x = x_of(h, cin)
        w, bias = _conv_w(gen, cin, cout, 3, dev)
        args = (x, w, bias)
        pairs += _held_to_float64(f"conv3x3 {h}^2 {cin}->{cout}", ck.conv3x3(*args, True),
                                  ck.conv3x3_plain(*args, True),
                                  lambda *a: ck.conv3x3_plain(*a, True), args)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        work[0] += nbytes(x, w, bias) + b * h * h * cout * 4
        work[1] += 2 * b * h * h * 9 * cin * cout
        kfns.append(lambda a=args: ck.conv3x3(*a, True))
        pfns.append(lambda a=args: ck.conv3x3_plain(*a, True))
        lfns.append(lambda a=(x_nchw, w_oihw, bias): F.conv2d(*a, padding=1))
    entry("conv3x3", "tomosar2height_tpu_torch/csrc/conv.cu",
          "tomosar2height_tpu/ops/pallas/conv_kernel.py:43", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns],
          (work[0], [(work[1], TF32X3_FLOP_S)]), lambda: [fn() for fn in lfns], iters=3)
    del pairs, kfns, pfns, lfns

    pairs, kfns, pfns, work = [], [], [], [0, 0]
    for h, cin, c, pool in ALTO_PAIRS + IMAGE_PAIRS:
        x = x_of(h, cin)
        args = (x, *_conv_w(gen, cin, c, 3, dev), *_conv_w(gen, c, c, 3, dev))
        ky, kp = cpk.conv_pair(*args, pool)
        py, pp = cpk.conv_pair_plain(*args, pool)
        name = f"conv_pair {h}^2 {cin}->{c}->{c}"
        pairs += _held_to_float64(name, (ky, kp), (py, pp),
                                  lambda *a: cpk.conv_pair_plain(*a, pool), args)
        work[0] += nbytes(*args, ky, kp)
        work[1] += 2 * b * h * h * 9 * (cin * c + c * c)
        kfns.append(lambda a=args, p=pool: cpk.conv_pair(*a, p))
        pfns.append(lambda a=args, p=pool: cpk.conv_pair_plain(*a, p))
    entry("conv_pair", "tomosar2height_tpu_torch/csrc/convpair.cu",
          "tomosar2height_tpu/ops/pallas/convpair_kernel.py:36", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns],
          (work[0], [(work[1], TF32X3_FLOP_S)]), iters=3)
    del pairs, kfns, pfns

    h, c0, (c1, c2, c3), co = DECODER
    x = x_of(h, c0)
    args = (x, *_conv_w(gen, c0, c1, 3, dev), *_conv_w(gen, c1, c2, 3, dev),
            *_conv_w(gen, c2, c3, 3, dev), *_conv_w(gen, c0 + c1 + c2 + c3, co, 1, dev))
    got = dk.conv_decoder(*args)
    # the three convs on 3xTF32, the 1x1 head on fp32 FMA
    ops = [(2 * b * h * h * 9 * (c0 * c1 + c1 * c2 + c2 * c3), TF32X3_FLOP_S),
           (2 * b * h * h * (c0 + c1 + c2 + c3) * co, FP32_FLOP_S)]
    entry("conv_decoder", "tomosar2height_tpu_torch/csrc/decoder.cu",
          "tomosar2height_tpu/ops/pallas/decoder_kernel.py:85",
          _held_to_float64("conv_decoder", got, dk.conv_decoder_plain(*args),
                           dk.conv_decoder_plain, args),
          lambda: dk.conv_decoder(*args), lambda: dk.conv_decoder_plain(*args),
          (nbytes(*args, got), ops), iters=5)
    torch.cuda.synchronize()


def _bf16_rule(name, kernel_fn, plain_fn, args):
    """[(kernel output, float64 reference, tolerance, 0)] of a bf16 conv kernel
    (a pair for each output): the reference is the plain function evaluated
    in float64 on the same operands (bf16 values), and the kernel's distance
    from it may be at most 2x the bf16 plain version's plus one bf16 ulp of
    the output's scale (2^-7 of the power of two at or below its largest
    |value|). The kernel is also held bit-equal on a second launch. Returns
    (pairs, (the largest share of its tolerance the kernel used, a note with
    the share of outputs where kernel and plain differ))."""
    import torch

    got, again, want = kernel_fn(*args), kernel_fn(*args), plain_fn(*args)
    ref = plain_fn(*(a.double() for a in args))
    got, again, want, ref = ((t if isinstance(t, tuple) else (t,)) for t in (got, again,
                                                                           want, ref))
    pairs, worst = [], (0.0, "")
    for g, a, w, r in zip(got, again, want, ref):
        if g is None:
            continue
        if not torch.equal(g, a):
            raise AssertionError(f"{name}: two launches differ")
        ulp = 2.0 ** (float(torch.floor(torch.log2(r.abs().max()))) - 7)
        plain_err = float((w.double() - r).abs().max())
        tol = 2 * plain_err + ulp
        err = float((g.double() - r).abs().max())
        pairs.append((g.double(), r, tol, 0.0))
        worst = max(worst, (err / tol, f"{name}: kernel {err:.3g}, plain {plain_err:.3g} "
                            f"from float64 (tol {tol:.3g}); kernel != plain at "
                            f"{float((g != w).float().mean()):.3g} of the outputs"))
    return pairs, worst


def check_conv_kernels_bf16(entry, seed: int = 0):
    """K8, K7 and K6 on bf16 activations at the shapes of the f32 rows
    (CONVS, ALTO_PAIRS + IMAGE_PAIRS, DECODER), batch 8: each held to
    ``_bf16_rule`` and timed beside its bf16 plain version; K8 also beside
    ``F.conv2d`` in bf16 on ``channels_last`` (cuDNN), in all and at each
    shape, with the route each shape takes (``conv3x3_bf16_wgmma``, or
    ``conv3x3_bf16_flat`` for Cin = 3). Operands are bf16
    values: x and K8's kernel in bf16, K7's and K6's weights and biases
    rounded to bf16 and passed in f32, as the model passes its parameters;
    K8's bias f32."""
    import torch
    import torch.nn.functional as F

    from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
    from tomosar2height_tpu_torch.ops.cuda import convpair_kernel as cpk
    from tomosar2height_tpu_torch.ops.cuda import decoder_kernel as dk
    from tomosar2height_tpu_torch.ops.cuda import runtime, tile_plan

    dev, bf = torch.device(DEVICE), torch.bfloat16
    gen = torch.Generator().manual_seed(seed + 8)
    xgen = torch.Generator(device=dev).manual_seed(seed + 8)
    b = 8
    x_of = lambda h, c: torch.randn(b, h, h, c, generator=xgen, device=dev).to(bf)  # noqa: E731

    def w_of(cin, cout, k=3):
        return tuple(t.to(bf).float() for t in _conv_w(gen, cin, cout, k, dev))

    pairs, notes, kfns, pfns, lfns, work, per = [], [], [], [], [], [0, 0], []
    routes = ("conv3x3_bf16_wgmma", "conv3x3_bf16_flat")
    before = {k: runtime.LAUNCHES[k] for k in routes}
    for h, cin, cout in CONVS:
        w, bias = _conv_w(gen, cin, cout, 3, dev)
        args = (x_of(h, cin), w.to(bf), bias)
        got, note = _bf16_rule(f"conv3x3_bf16 {h}^2 {cin}->{cout}",
                               lambda *a: ck.conv3x3(*a, True),
                               lambda *a: ck.conv3x3_plain(*a, True), args)
        pairs += got
        notes.append(note)
        lib = (args[0].permute(0, 3, 1, 2), args[1].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last), args[2].to(bf))
        work[0] += nbytes(*args) + b * h * h * cout * 2
        work[1] += 2 * b * h * h * 9 * cin * cout
        kfns.append(lambda a=args: ck.conv3x3(*a, True))
        pfns.append(lambda a=args: ck.conv3x3_plain(*a, True))
        lfns.append(lambda a=lib: F.conv2d(*a, padding=1))
        per.append(f"{h}^2 {cin}->{cout} {tile_plan.conv_route(cin, cout)}")
    by_route = {k: runtime.LAUNCHES[k] - before[k] for k in routes}
    log("kernels", f"conv3x3_bf16 at the {len(CONVS)} shapes, the largest share of its "
        f"tolerance: {max(notes)[0]:.3f}, {max(notes)[1]}; launches by route (two a "
        f"shape) {by_route}")
    per = [f"{p} {graph_ms(k, 3):.4f}/{graph_ms(lf, 3):.4f}"
           for p, k, lf in zip(per, kfns, lfns)]
    log("kernels", "conv3x3_bf16 by shape (route, kernel / cuDNN bf16 channels_last ms, "
        "graph replays, median of 3): " + "; ".join(per))
    entry("conv3x3_bf16", "tomosar2height_tpu_torch/csrc/conv_bf16.cu",
          "tomosar2height_tpu/ops/pallas/conv_kernel.py:43", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns],
          (work[0], [(work[1], BF16_FLOP_S)]), lambda: [fn() for fn in lfns],
          tol="2x plain's distance from float64 + 1 bf16 ulp", iters=3)
    del pairs, kfns, pfns, lfns

    pairs, notes, kfns, pfns, work, per, cudnn = [], [], [], [], [0, 0], [], []
    routes = ("conv_pair_bf16_wgmma", "conv_pair_bf16_flat")
    before = {k: runtime.LAUNCHES[k] for k in routes}
    for h, cin, c, pool in ALTO_PAIRS + IMAGE_PAIRS:
        args = (x_of(h, cin), *w_of(cin, c), *w_of(c, c))
        got, note = _bf16_rule(f"conv_pair_bf16 {h}^2 {cin}->{c}->{c}",
                               lambda *a, p=pool: cpk.conv_pair(*a, p),
                               lambda *a, p=pool: cpk.conv_pair_plain(*a, p), args)
        pairs += got
        notes.append(note)
        work[0] += nbytes(*args) + b * h * h * c * 2 * (1.25 if pool else 1)
        work[1] += 2 * b * h * h * 9 * (cin * c + c * c)
        kfns.append(lambda a=args, p=pool: cpk.conv_pair(*a, p))
        pfns.append(lambda a=args, p=pool: cpk.conv_pair_plain(*a, p))
        # cuDNN's two bf16 convs at the pair's shapes (channels_last; no
        # ReLU, no pool): information beside the row, not its library call
        lib = [(t.permute(0, 3, 1, 2), k.to(bf).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last), bb.to(bf)) for t, k, bb in (
            (args[0], args[1], args[2]),
            (torch.empty(b, h, h, c, device=dev, dtype=bf).normal_(generator=xgen),
             args[3], args[4]))]
        cudnn.append(lambda a=lib: [F.conv2d(*x, padding=1) for x in a])
        per.append(f"{h}^2 {cin}->{c}->{c}{' pool' if pool else ''} "
                   + "+".join(tile_plan.conv_route(*ch) for ch in ((cin, c), (c, c))))
    by_route = {k: runtime.LAUNCHES[k] - before[k] for k in routes}
    log("kernels", f"conv_pair_bf16 at the {len(ALTO_PAIRS + IMAGE_PAIRS)} shapes, the "
        f"largest share of its tolerance: {max(notes)[0]:.3f}, {max(notes)[1]}; its convs "
        f"by route (two launches a shape, two convs each) {by_route}")
    per = [f"{p} {graph_ms(k, 3):.4f}/{graph_ms(lf, 3):.4f}"
           for p, k, lf in zip(per, kfns, cudnn)]
    log("kernels", "conv_pair_bf16 by shape (the convs' routes, kernel / cuDNN's two bf16 "
        "F.conv2d on channels_last ms, graph replays, median of 3): " + "; ".join(per)
        + f"; all shapes: cuDNN's {graph_ms(lambda: [fn() for fn in cudnn], 3):.4f} ms")
    del cudnn
    entry("conv_pair_bf16", "tomosar2height_tpu_torch/csrc/conv_bf16.cu",
          "tomosar2height_tpu/ops/pallas/convpair_kernel.py:36", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns],
          (work[0], [(work[1], BF16_FLOP_S)]),
          tol="2x plain's distance from float64 + 1 bf16 ulp", iters=3)
    del pairs, kfns, pfns

    h, c0, (c1, c2, c3), co = DECODER
    args = (x_of(h, c0), *w_of(c0, c1), *w_of(c1, c2), *w_of(c2, c3),
            *w_of(c0 + c1 + c2 + c3, co, 1))
    routes = ("conv_decoder_bf16_wgmma", "conv_decoder_bf16_flat")
    before = {k: runtime.LAUNCHES[k] for k in routes}
    got, note = _bf16_rule("conv_decoder_bf16", dk.conv_decoder, dk.conv_decoder_plain, args)
    by_route = {k: runtime.LAUNCHES[k] - before[k] for k in routes}
    # cuDNN's three bare bf16 convs at K6's shapes (channels_last; no ReLU,
    # no head): information beside the row, not its library call
    lib = [(t.permute(0, 3, 1, 2), k.to(bf).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last), bb.to(bf)) for t, k, bb in zip(
        (args[0], x_of(h, c1), x_of(h, c2)), args[1:7:2], args[2:7:2])]
    cudnn = graph_ms(lambda: [F.conv2d(*x, padding=1) for x in lib], 3)
    log("kernels", f"conv_decoder_bf16, the share of its tolerance: {note[0]:.3f}, "
        f"{note[1]}; its convs by route (two launches, three convs each) {by_route}; "
        f"cuDNN's three bare bf16 F.conv2d on channels_last at its shapes {cudnn:.4f} ms "
        f"(graph replays, median of 3)")
    del lib
    # the three convs on bf16 tensor cores, the 1x1 head on fp32 FMA
    ops = [(2 * b * h * h * 9 * (c0 * c1 + c1 * c2 + c2 * c3), BF16_FLOP_S),
           (2 * b * h * h * (c0 + c1 + c2 + c3) * co, FP32_FLOP_S)]
    entry("conv_decoder_bf16", "tomosar2height_tpu_torch/csrc/conv_bf16.cu",
          "tomosar2height_tpu/ops/pallas/decoder_kernel.py:85", got,
          lambda: dk.conv_decoder(*args), lambda: dk.conv_decoder_plain(*args),
          (nbytes(*args) + b * h * h * co * 4, ops),
          tol="2x plain's distance from float64 + 1 bf16 ulp", iters=5)
    torch.cuda.synchronize()


# (reso, F) of the tile kernels' calls in a flagship forward on the 'fused'
# and 'pallas' paths: the plane scatter at 256^2 (F=32), then the eight level
# round trips (LEVEL_SHAPES' reso and F); the sample (K9) at the eight levels
TILE_SCATTER_SHAPES = [(256, 32)] + [(r, f) for r, f, _ in LEVEL_SHAPES]
TILE_GATHER_SHAPES = [(r, f) for r, f, _ in LEVEL_SHAPES]


def _scatter_yardstick(vals, cells, shift, ncell, dev, reduce="mean"):
    """One ``scatter_reduce`` (mean, or amax for a max pooling) over the flat
    (B * ncell) cells in the values' dtype, rows with no cell in one spare
    row: the library call that computes a tile scatter-mean (or pooling)."""
    import torch

    b, n, f = vals.shape
    cell = cells.long() >> shift
    flat = torch.where(cell < ncell, cell + ncell * torch.arange(b, device=dev)[:, None],
                       torch.full_like(cell, b * ncell)).reshape(-1)
    idx = flat[:, None].expand(-1, f)
    src = vals.reshape(-1, f)
    return lambda: torch.zeros(b * ncell + 1, f, device=dev, dtype=vals.dtype).scatter_reduce_(
        0, idx, src, reduce, include_self=False)


def _dtype_rule(dt):
    """(row suffix, the maker of comparison pairs, tolerance text) of the rows in
    ``dt``: float32 held to TOL, bfloat16 to one bf16 ulp of the bf16 plain
    version (ULP_RULE)."""
    import torch

    if dt == torch.float32:
        return "", lambda got, want: (got, want), f"{TOL:g} abs+rel"
    return ("_bf16", lambda got, want: (got.float(), want.float(), _ulp_tol(want), 0.0),
            ULP_RULE)


def check_tile_kernels(entry, seed: int = 0, dt=None):
    """K9-K14 against their plain versions at every shape one flagship
    forward gives them, in ``dt`` (float32, or bfloat16: rows ``*_bf16``
    within one bf16 ulp of their bf16 plain versions, max exact): K9/K12/K10
    on the aligned layout with 256-cell tiles ('fused'), K11/K13 on the plain
    sorted layout ('pallas'), K14 at 256-32; B=8, 16384-point buckets. In
    bf16 also the d_plane pass from f32 cotangents into a bf16 plane (the
    backward of the 'cumsum' layout's samples) on the plain sorted layout."""
    import torch
    import torch.nn.functional as F

    from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk
    from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk
    from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk

    dt = dt or torch.float32
    sfx, close, tol = _dtype_rule(dt)
    dev = torch.device(DEVICE)
    pts, mask_np, apts, amask, acell, toff_np = flagship_batch(seed + 5, tile_cells=256)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    xy, mask, cells, toff = up(apts[..., :2]), up(amask), up(acell), up(toff_np)
    b, npad = amask.shape
    log("kernels", f"tile kernels in {dt}: B={b} Npad={npad} (256-cell tiles) "
        f"valid={int(amask.sum())}")

    def level_toff(r):
        return toff[:, :: 4 ** ((256).bit_length() - r.bit_length())].contiguous()

    def rows_of(f, n=npad, m=mask):
        return (torch.randn(b, n, f, generator=gen, device=dev) * m[..., None]).to(
            dt).contiguous()

    # bounds count what each kernel must read: values on the rows that add
    # into a cell (in range and in their tile), the cell ids of the rows it
    # walks, the tile offsets, and its output written once
    def scatter_bytes(v, c, tl, shift, r, out, walked):
        """Bytes of a tile scatter of v (B, N, F) at r^2 under tile offsets
        tl: ``walked`` (B, N) marks the rows whose ids it reads."""
        valid = sk.tile_rows(c, tl, shift, r * r)[1]
        return (int(valid.sum()) * v.shape[-1] * v.element_size() + int(walked.sum()) * 4
                + nbytes(tl, out))

    in_tiles = torch.arange(npad, device=dev)[None, :] < toff[:, -1:]  # rows in the tiles

    # K9: the eight round trips' samples; every row is written, the rows in
    # the tiles' ranges read their coordinates, the plane is read at the
    # pixels their corners touch
    def touched_pixels(r):
        p = (xy * (r - 1)).clamp(0, r - 1)
        x0, y0 = (p[..., k].floor().long().clamp(0, r - 1) for k in (0, 1))
        bb = torch.arange(b, device=dev)[:, None].expand_as(x0)
        idx = [((bb * r + y) * r + x)[in_tiles] for y in (y0, (y0 + 1).clamp(max=r - 1))
               for x in (x0, (x0 + 1).clamp(max=r - 1))]
        return int(torch.unique(torch.cat(idx)).numel())

    pairs, kfns, pfns, lfns, work, repeat = [], [], [], [], [0, 0], True
    esize = torch.empty((), dtype=dt).element_size()
    for r, f in TILE_GATHER_SHAPES:
        plane = torch.randn(b, r, r, f, generator=gen, device=dev).to(dt)
        a = (plane, xy, level_toff(r))
        out = gk.tile_gather(*a)
        repeat = repeat and torch.equal(out, gk.tile_gather(*a))
        pairs.append(close(out, gk.tile_gather_plain(*a)))
        work[0] += touched_pixels(r) * f * esize + int(in_tiles.sum()) * 8 + nbytes(a[2], out)
        work[1] += 8 * b * npad * f
        kfns.append(lambda a=a: gk.tile_gather(*a))
        pfns.append(lambda a=a: gk.tile_gather_plain(*a))
        grid = (2 * xy - 1)[:, :, None, :].to(dt)
        lfns.append(lambda p=plane.permute(0, 3, 1, 2), g=grid: F.grid_sample(
            p, g, padding_mode="border", align_corners=True))
    log("kernels", f"tile_gather{sfx} bit-equal on a second launch at its 8 shapes: {repeat}")
    if not repeat:
        raise AssertionError(f"tile_gather{sfx} differs between two launches")
    entry("tile_gather" + sfx, "tomosar2height_tpu_torch/csrc/tile_gather.cu",
          "tomosar2height_tpu/ops/pallas/gather_kernel.py:69", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], work,
          lambda: [fn() for fn in lfns], tol=tol)
    del pairs, kfns, pfns, lfns

    # K10: the four poolings (F=32 at 256^2), max and mean, on pool2's run
    # kernel under the tile rule: three copies of its inputs in turn (as
    # pool2.cu's rows), each kind logged, a second launch held bit-equal;
    # every row written; max exact in bf16
    vals = rows_of(32)
    copies = [(vals, cells, toff)] + [tuple(x.clone() for x in (vals, cells, toff))
                                      for _ in range(2)]
    pairs, by_kind, repeat = [], [], True
    for k in ("max", "mean"):
        out = tpk.tile_pool(vals, cells, toff, k)
        want = tpk.tile_pool_plain(vals, cells, toff, k)
        pairs.append((out.float(), want.float(), 0.0, 0.0) if k == "max" and sfx
                     else close(out, want))
        repeat = repeat and torch.equal(out, tpk.tile_pool(vals, cells, toff, k))
        ms = graph_ms([lambda a=a, k=k: tpk.tile_pool(*a, k) for a in copies])
        by_kind.append(f"{k} {ms:.4f}")
    log("kernels", f"tile_pool{sfx} by kind, kernel ms (three copies): {'; '.join(by_kind)} | "
        f"bit-equal on a second launch: {repeat}")
    if not repeat:
        raise AssertionError(f"tile_pool{sfx} differs between two launches")
    entry("tile_pool" + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/pool_kernel.py:36", pairs,
          [lambda a=a: tpk.tile_pool(*a, "max") for a in copies],
          [lambda a=a: tpk.tile_pool_plain(*a, "max") for a in copies],
          (scatter_bytes(vals, cells, toff, 0, 256, pairs[0][0].to(dt), in_tiles),
           vals.numel()),
          _scatter_yardstick(vals, cells, 0, 256 * 256, dev, "amax"),
          tol=tol + ("; max exact" if sfx else ""))
    del pairs, vals, copies

    def run_scatter_row(name, replaces, fn, plain, shapes):
        """The row of a run scatter (K11-K13: ``scatter_runs``): ``shapes``
        lists (label, the call's arguments on each of three input copies,
        bytes(out), library yardstick) per shape; each shape timed on the
        copies in turn (as pool2.cu's rows) and logged kernel/plain/bound,
        a second launch held bit-equal."""
        args, pairs, lfns, work, by_shape, repeat = [[], [], []], [], [], [0, 0], [], True
        for label, shape_args, bytes_of, lfn in shapes:
            a = shape_args[0]
            out = fn(*a)
            pairs.append(close(out, plain(*a)))
            repeat = repeat and torch.equal(out, fn(*a))
            moved = bytes_of(out)
            work[0] += moved
            work[1] += a[0].numel()
            ms = graph_ms([lambda a=a: fn(*a) for a in shape_args])
            by_shape.append(f"{label} {ms:.4f}/{graph_ms(lambda: plain(*a), 3, 1):.4f}/"
                            f"{bound(moved, a[0].numel())[0]:.4f}")
            for k, sa in enumerate(shape_args):
                args[k].append(sa)
            lfns.append(lfn)
        log("kernels", f"{name} by shape, kernel (three copies)/plain/bound ms: "
            f"{'; '.join(by_shape)} | bit-equal on a second launch: {repeat}")
        if not repeat:
            raise AssertionError(f"{name} differs between two launches")
        entry(name, "tomosar2height_tpu_torch/csrc/pool2.cu", replaces, pairs,
              [lambda sa=sa: [fn(*a) for a in sa] for sa in args],
              [lambda sa=sa: [plain(*a) for a in sa] for sa in args],
              work, lambda: [f() for f in lfns], tol=tol)

    # K12 (the nine scatters, plus 16^2 at F=1024) on the run scatter. It
    # reads every row's id, and clears and reads B * r^2 bytes of flags
    copies = [(cells, toff)] + [(cells.clone(), toff.clone()) for _ in range(2)]
    shapes = []
    for r, f in TILE_SCATTER_SHAPES + [(16, 1024)]:
        shift = 2 * (9 - r.bit_length())
        v = rows_of(f)
        sa = [(v if k == 0 else v.clone(), c, t[:, :: 4 ** (shift // 2)].contiguous(), r, 256)
              for k, (c, t) in enumerate(copies)]
        shapes.append((f"{r}^2 F={f}", sa,
                       lambda out, a=sa[0], shift=shift, r=r: b * r * r + scatter_bytes(
                           a[0], cells, a[2], shift, r, out, torch.ones_like(mask)),
                       _scatter_yardstick(v, cells, shift, r * r, dev)))
    run_scatter_row("aligned_scatter_mean_plane" + sfx,
                    "tomosar2height_tpu/ops/pallas/scatter_kernel.py:242",
                    sk.aligned_scatter_mean_plane, sk.aligned_scatter_mean_plane_plain, shapes)
    del shapes, copies

    check_tile_backwards(entry, dev, b, npad, xy, mask, cells, toff, rows_of, scatter_bytes,
                         dt)

    # K14 (256-32 .. 32-512) on 'fused', on the run scatter from the finest
    # tile offsets (read every 4**level-th), held bit-equal on a second
    # launch; its bound counts the ids of the rows inside the tiles' ranges
    pairs, kfns, pfns, lfns, work = [], [], [], [], [0, 0]
    for r, f in [(256, 32), (128, 128), (64, 256), (32, 512)]:
        shift = 2 * (9 - r.bit_length())
        a = (rows_of(f), cells, toff, r, 256)
        out = sk.scatter_mean_plane_v3(*a)
        if not torch.equal(sk.scatter_mean_plane_v3(*a), out):
            raise AssertionError(f"scatter_mean_plane_v3{sfx} differs between two launches "
                                 f"at {r}")
        pairs.append(close(out, sk.scatter_mean_plane_v3_plain(*a)))
        tl = toff[:, :: 4 ** (shift // 2)].contiguous()
        work[0] += scatter_bytes(a[0], cells, tl, shift, r, out, in_tiles)
        work[1] += a[0].numel()
        kfns.append(lambda a=a: sk.scatter_mean_plane_v3(*a))
        pfns.append(lambda a=a: sk.scatter_mean_plane_v3_plain(*a))
        lfns.append(_scatter_yardstick(a[0], cells, shift, r * r, dev))
    log("kernels", f"scatter_mean_plane_v3{sfx} bit-equal on a second launch at its 4 "
        "shapes: True")
    entry("scatter_mean_plane_v3" + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/scatter_kernel.py:495", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], work,
          lambda: [fn() for fn in lfns], tol=tol)
    del pairs, kfns, pfns, lfns

    # K11 on the plain sorted layout: the nine plane scatters, on the run
    # scatter (tile offsets every 256th per-cell offset, read in place); K13
    # on the same inputs: the mean poolings, at every level's width, into the
    # Morton-ordered cell vector. Their bounds count the ids of the rows they
    # walk as the valid rows (pads sort past the last tile)
    spts, smask, scells, soffs = (up(x) for x in sorted_layout(pts, mask_np))
    copies = [(scells, soffs)] + [(scells.clone(), soffs.clone()) for _ in range(2)]
    shapes = []
    for r, f in TILE_SCATTER_SHAPES:
        shift = 2 * (9 - r.bit_length())
        v = rows_of(f, smask.shape[1], smask)
        sa = [(v if k == 0 else v.clone(), (c >> shift).contiguous(),
               o[:, :: 4 ** (shift // 2)].contiguous(), r) for k, (c, o) in enumerate(copies)]
        tl = sa[0][2][:, ::256]
        walked = torch.arange(smask.shape[1], device=dev)[None, :] < tl[:, -1:]
        shapes.append((f"{r}^2 F={f}", sa,
                       lambda out, a=sa[0], tl=tl, r=r, w=walked: scatter_bytes(
                           a[0], a[1], tl, 0, r, out, w),
                       _scatter_yardstick(v, sa[0][1], 0, r * r, dev)))
    run_scatter_row("scatter_mean_plane" + sfx,
                    "tomosar2height_tpu/ops/pallas/scatter_kernel.py:124",
                    sk.scatter_mean_plane, sk.scatter_mean_plane_plain, shapes)
    run_scatter_row("scatter_mean" + sfx, "tomosar2height_tpu/ops/pallas/scatter_kernel.py:65",
                    sk.scatter_mean, sk.scatter_mean_plain, shapes)
    del shapes, copies
    if sfx:
        check_wide_d_plane(entry, spts[..., :2].contiguous(), smask, scells, gen)
    torch.cuda.synchronize()


def check_wide_d_plane(entry, xy, mask, cells, gen):
    """The d_plane pass from f32 cotangents into a bf16 plane
    (``level_d_plane_wide_bf16``): the backward of the f32 sample of a bf16
    plane on the 'cumsum' (and 'pallas') layout, at the eight round trips'
    shapes on the plain sorted layout, within one bf16 ulp of its plain
    version (the same f32 sums rounded once), bit-equal on a second launch;
    yardstick ``F.grid_sample``'s backward in f32."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk

    dev = xy.device
    b, n = mask.shape
    n_valid = int(mask.sum())
    pairs, kfns, pfns, lfns, work = [], [], [], [], [0, 0]
    for r, f in TILE_GATHER_SHAPES:
        g = (torch.randn(b, n, f, generator=gen, device=dev) * mask[..., None]).contiguous()
        a = (g, xy, cells, mask, r, 256, torch.bfloat16)
        out = lk.level_d_plane(*a)
        if not torch.equal(lk.level_d_plane(*a), out):
            raise AssertionError(f"level_d_plane_wide_bf16 differs between two launches at {r}")
        want = lk.level_d_plane_plain(*a)
        pairs.append((out.float(), want.float(), _ulp_tol(want), 0.0))
        # g and xy on the valid rows, every row's id and mask, the finest
        # cells' row ranges cleared, written and read, d_plane written once
        work[0] += n_valid * (f + 2) * 4 + nbytes(cells, mask, out) + 2 * 2 * b * 256 * 256 * 4
        work[1] += 2 * 4 * n_valid * f
        kfns.append(lambda a=a: lk.level_d_plane(*a))
        pfns.append(lambda a=a: lk.level_d_plane_plain(*a))
        gin = torch.empty(b, f, r, r, device=dev)
        gout = g.permute(0, 2, 1)[..., None].contiguous()
        grid = (2 * xy - 1)[:, :, None, :].contiguous()
        lfns.append(lambda a=(gout, gin, grid): torch.ops.aten.grid_sampler_2d_backward(
            *a, 0, 1, True, [True, False])[0])
    log("kernels", "level_d_plane_wide_bf16 bit-equal on a second launch at its 8 shapes: True")
    entry("level_d_plane_wide_bf16", "tomosar2height_tpu_torch/csrc/level_bwd.cu",
          "tomosar2height_tpu/ops/pallas/level_bwd_kernel.py:68", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], tuple(work),
          lambda: [fn() for fn in lfns], tol=ULP_RULE)


def check_tile_backwards(entry, dev, b, npad, xy, mask, cells, toff, rows_of, scatter_bytes,
                         dt):
    """The fused layout's backwards (its training step) against their plain
    versions at every shape a flagship step gives them, in ``dt`` (bfloat16:
    rows ``*_bf16`` within one bf16 ulp of their bf16 plain versions), each
    bit-equal on a second launch: K9's on K5's d_plane pass (the eight
    samples, K5's d_plane rule; yardstick F.grid_sample's backward), K10's
    on the run kernel (max: each run's cotangent split among its rows tied
    with the max; mean; on three input copies, and once more on integral
    values, whose cells tie), K12's on K2 alone at the level's shift with the
    forward's counts (bf16: each count cut to bf16; its ten shapes;
    yardstick an index_select as K2's)."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk
    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
    from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk
    from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk

    sfx, close, tol = _dtype_rule(dt)
    esize = torch.empty((), dtype=dt).element_size()
    gen = torch.Generator(device=dev).manual_seed(17)
    n_valid = int(mask.sum())
    pairs, kfns, pfns, lfns, work = [], [], [], [], [0, 0]
    for r, f in TILE_GATHER_SHAPES:
        g = (torch.randn(b, npad, f, generator=gen, device=dev) * mask[..., None]).to(
            dt).contiguous()
        a = (g, xy, cells, mask, r, 256)
        out = gk.tile_gather_bwd(*a)
        if not torch.equal(gk.tile_gather_bwd(*a), out):
            raise AssertionError(f"tile_gather_bwd{sfx} differs between two launches at {r}")
        want = lk.level_d_plane_plain(*a)
        pairs.append(close(out, want) if sfx else (out, want, *BWD_TOL))
        # g and xy on the valid rows, every row's id and mask, the finest
        # cells' row ranges cleared, written and read, d_plane written once;
        # a multiply-add a corner and feature
        work[0] += (n_valid * (f * esize + 8) + nbytes(cells, mask, out)
                    + 2 * 2 * b * 256 * 256 * 4)
        work[1] += 2 * 4 * n_valid * f
        kfns.append(lambda a=a: gk.tile_gather_bwd(*a))
        pfns.append(lambda a=a: lk.level_d_plane_plain(*a))
        gin = torch.empty(b, f, r, r, device=dev, dtype=dt)
        gout = g.permute(0, 2, 1)[..., None].contiguous()
        grid = (2 * xy - 1)[:, :, None, :].to(dt).contiguous()
        lfns.append(lambda a=(gout, gin, grid): torch.ops.aten.grid_sampler_2d_backward(
            *a, 0, 1, True, [True, False])[0])
    log("kernels", f"tile_gather_bwd{sfx} bit-equal on a second launch at its 8 shapes: True")
    entry("tile_gather_bwd" + sfx, "tomosar2height_tpu_torch/csrc/level_bwd.cu",
          "tomosar2height_tpu/ops/pallas/fused.py:65", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], tuple(work),
          lambda: [fn() for fn in lfns],
          tol=tol if sfx else f"{BWD_TOL[0]:g} abs + {BWD_TOL[1]:g} rel")
    del pairs, kfns, pfns, lfns

    # K10's backward at the four poolings' width (F=32 at 256^2)
    vals = rows_of(32)
    g = rows_of(32)
    ties = (torch.randint(0, 3, vals.shape, generator=gen, device=dev).float()
            * mask[..., None]).to(dt).contiguous()
    pairs, by_kind, repeat = [], [], True
    copies = {}
    for k in ("max", "mean"):
        out = tpk.tile_pool(vals, cells, toff, k)
        a = (g, vals, out, cells, toff, k)
        dv = tpk.tile_pool_bwd(*a)
        pairs.append(close(dv, tpk.tile_pool_bwd_plain(*a)))
        repeat = repeat and torch.equal(dv, tpk.tile_pool_bwd(*a))
        copies[k] = [a] + [tuple(x.clone() if torch.is_tensor(x) else x for x in a)
                           for _ in range(2)]
        ms = graph_ms([lambda a=a: tpk.tile_pool_bwd(*a) for a in copies[k]])
        by_kind.append(f"{k} {ms:.4f}")
    t_out = tpk.tile_pool(ties, cells, toff, "max")
    a = (g, ties, t_out, cells, toff, "max")
    dv = tpk.tile_pool_bwd(*a)
    pairs.append(close(dv, tpk.tile_pool_bwd_plain(*a)))
    repeat = repeat and torch.equal(dv, tpk.tile_pool_bwd(*a))
    tied = int(((ties == t_out) & mask[..., None]).sum())
    log("kernels", f"tile_pool_bwd{sfx} by kind, kernel ms (three copies): "
        f"{'; '.join(by_kind)} | on integral values {tied} tied row features | bit-equal on "
        f"a second launch: {repeat}")
    if not repeat:
        raise AssertionError(f"tile_pool_bwd{sfx} differs between two launches")
    in_tiles = torch.arange(npad, device=dev)[None, :] < toff[:, -1:]
    entry("tile_pool_bwd" + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/fused.py:118", pairs,
          [lambda a=a: tpk.tile_pool_bwd(*a) for a in copies["max"]],
          [lambda a=a: tpk.tile_pool_bwd_plain(*a) for a in copies["max"]],
          # g, values and out on the valid rows (the gate), ids and tile
          # offsets, dv written
          (scatter_bytes(g, cells, toff, 0, 256, dv, in_tiles)
           + 2 * n_valid * 32 * esize, 2 * g.numel()), None, tol=tol)
    del pairs, copies

    # K12's backward at its ten shapes, with the forward's counts
    pairs, kfns, pfns, lfns, work = [], [], [], [], [0, 0]
    arange_b = torch.arange(b, device=dev)[:, None]
    for r, f in TILE_SCATTER_SHAPES + [(16, 1024)]:
        shift = 2 * (9 - r.bit_length())
        tl = toff[:, :: 4 ** (shift // 2)].contiguous()
        _, counts = sk.aligned_scatter_mean_plane(rows_of(f), cells, tl, r, 256,
                                                  with_counts=True)
        gp = torch.randn(b, r, r, f, generator=gen, device=dev).to(dt)
        a = (gp, cells, counts, r, 256)
        dv = sk.aligned_scatter_mean_plane_bwd(*a)
        if not torch.equal(sk.aligned_scatter_mean_plane_bwd(*a), dv):
            raise AssertionError(f"aligned_scatter_mean_plane_bwd{sfx} differs between two "
                                 f"launches at {r}")
        pairs.append(close(dv, sk.aligned_scatter_mean_plane_bwd_plain(*a)))
        occupied = int((counts > 0).sum())
        work[0] += (nbytes(gp, counts) * occupied // counts.numel()
                    + nbytes(cells, dv))
        work[1] += dv.numel()
        kfns.append(lambda a=a: sk.aligned_scatter_mean_plane_bwd(*a))
        pfns.append(lambda a=a: sk.aligned_scatter_mean_plane_bwd_plain(*a))
        # the yardstick: one index_select of the row-major plane (a zero row
        # appended for the pad rows) and one of the counts, then the division
        # (in bf16 the counts promote to bf16, as K12's backward cuts them)
        c = cells.long() >> shift
        ok = c < r * r
        rm = morton_rowmajor(torch.where(ok, c, 0), r) + r * r * arange_b
        rm = torch.where(ok, rm, torch.full_like(rm, b * r * r)).reshape(-1)
        gp_pad = torch.cat([gp.reshape(-1, f), torch.zeros(1, f, device=dev, dtype=dt)])
        kc_pad = torch.cat([counts.reshape(-1), torch.ones(1, device=dev, dtype=torch.int32)])
        lfns.append(lambda a=(gp_pad, kc_pad, rm): a[0].index_select(0, a[2])
                    / a[1].index_select(0, a[2]).clamp_min(1)[:, None])
    log("kernels", f"aligned_scatter_mean_plane_bwd{sfx} bit-equal on a second launch at its "
        "10 shapes: True")
    entry("aligned_scatter_mean_plane_bwd" + sfx, "tomosar2height_tpu_torch/csrc/pool2.cu",
          "tomosar2height_tpu/ops/pallas/fused.py:149", pairs,
          lambda: [fn() for fn in kfns], lambda: [fn() for fn in pfns], tuple(work),
          lambda: [fn() for fn in lfns], tol=tol)


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


SERVE_WORKERS, SERVE_PREFETCH = 4, 2  # the serving phase's worker-pool run


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
    # the timed run on the synchronous loader; then its worker pool
    cfg["dataloader"] = {"n_workers": 0, "prefetch": 0}
    gen = make_generator(model, cfg, chunks)
    plain_cfg = json.loads(json.dumps(cfg))
    plain_cfg["dataset"]["points"]["sort"] = False
    plain_gen = make_generator(model, plain_cfg, chunks)
    pool_cfg = json.loads(json.dumps(cfg))
    pool_cfg["dataloader"] = {"n_workers": SERVE_WORKERS, "prefetch": SERVE_PREFETCH}
    pool_gen = make_generator(model, pool_cfg, chunks)
    n_batches = len(gen.data_loader)
    with tempfile.TemporaryDirectory() as tmp:
        warm = gen.generate_dsm(os.path.join(tmp, "warmup.tif"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_launches()
        a = gen.generate_dsm(os.path.join(tmp, "fused2.tif"))
        launches = dict(runtime.LAUNCHES)
        # every kernel on the path writes each output once in a fixed order
        repeat = np.array_equal(warm.data, a.data, equal_nan=True)
        stats = dict(gen.last_stats)
        peak = torch.cuda.max_memory_allocated()
        pool_gen.generate_dsm(os.path.join(tmp, "pool_warmup.tif"))
        pooled = pool_gen.generate_dsm(os.path.join(tmp, "pool.tif"))
        pool_stats = dict(pool_gen.last_stats)
        runtime.reset_launches()
        b = plain_gen.generate_dsm(os.path.join(tmp, "plain.tif"))
        if any(runtime.LAUNCHES.values()):
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
    want = {**dict.fromkeys(launches, 0), "pool2": 4 * n_batches,
            "scatter_plane2": n_batches, "fused_level": 8 * n_batches,
            "fused_level_scatter": 8 * n_batches}
    log("serve", f"{stats['n_patches']} tiles in {n_batches} batches of "
        f"{gen.data_loader.batch_size} | "
        f"{stats['patches_per_s']:.2f} tiles/s ({stats['total_s']:.3f} s: loader "
        f"{stats['loader_s']:.3f} dispatch {stats['dispatch_s']:.3f} wait "
        f"{stats['fetch_wait_s']:.3f} blend {stats['blend_cpu_s']:.3f} write "
        f"{stats['finalize_write_s']:.3f}) | peak {peak / 2**30:.2f} GiB | raster "
        f"{da.shape} fused2 vs plain max|d| {err:.3g} m (tol {tol:.3g} m), "
        f"NaN px {int(nan.sum())}, fused2 bit-equal to its warm-up run {repeat} | "
        f"launches {launches}")
    pool_equal = np.array_equal(pooled.data, a.data, equal_nan=True)
    log("serve", f"loader with {SERVE_WORKERS} workers and prefetch {SERVE_PREFETCH}: "
        f"{pool_stats['patches_per_s']:.2f} tiles/s, loader {pool_stats['loader_s']:.3f} s "
        f"({pool_stats['total_s']:.3f} s) against the synchronous loader's "
        f"{stats['patches_per_s']:.2f} tiles/s, loader {stats['loader_s']:.3f} s | raster "
        f"bit-equal to the synchronous one {pool_equal}")
    if err > tol:
        raise AssertionError(f"fused2 and plain rasters differ by {err} m")
    if not repeat:
        raise AssertionError("two fused2 runs of the same scene gave different rasters")
    if not pool_equal:
        raise AssertionError("the worker pool's raster differs from the synchronous one")
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    return launches



# kernel launches per batch-8 forward of the fusion network on its kernel
# path (fused2 + fused_convs + fused_head; the footprint head is skipped when
# serving) and on the FAST_CONV path (unsorted, every Conv3x3 on K8). These
# count wrapper calls: one K6 call is three CUDA launches (its three convs),
# one K7 call two.
FUSION_LAUNCHES = {"pool2": 4, "scatter_plane2": 1, "fused_level": 8,
                   "fused_level_scatter": 8, "conv_pair": len(ALTO_PAIRS + IMAGE_PAIRS),
                   "conv_decoder": 1}
FAST_CONV_LAUNCHES = {"conv3x3": len(CONVS)}


def fusion_serve(seed: int = 0):
    """The cloud+image fusion network serving the synthetic city with its RGB
    image, batch 8, in three variants from the same weights: (a) fused2 +
    fused_convs + fused_head (K1-K4, K6, K7), (b) unsorted with FAST_CONV (K8
    only), (c) unsorted plain (no kernel). Each timed run is the second
    ``generate_dsm`` of its variant, launches counted from 0 around it, its
    raster bit-equal to the first's; (a) and (b) are held to (c); then (a)
    on every wire, held to (a)."""
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
    # the kernel path on every wire: u16 points, u8 image crops cut on the
    # card from the resident scene image, the host's cell ids, f16 rasters
    wires_cfg = json.loads(json.dumps(cfg))
    wires_cfg["dataset"]["points"]["wire"] = "uint16"
    wires_cfg["dataset"]["satellite_image"].update(wire="uint8", crop="device")
    variants = {"kernels": (cfg, model.eval(), False, FUSION_LAUNCHES, {}),
                "fast_conv": (plain_cfg, plain_model.eval(), True, FAST_CONV_LAUNCHES, {}),
                "plain": (plain_cfg, plain_model, False, {}, {}),
                "wires": (wires_cfg, model, False, FUSION_LAUNCHES,
                          {"wire_dtype": "float16", "wire_cells": "host"})}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (vcfg, vmodel, fast, per_batch, gen_kw) in variants.items():
            set_fast_conv(fast)
            gen = make_generator(vmodel, vcfg, chunks, image=image, **gen_kw)
            n_batches = len(gen.data_loader)
            batch = next(iter(gen.data_loader))
            up = {k: torch.from_numpy(batch[k]).to(DEVICE)
                  for k in ("points", "point_mask", "image", "cell", "cell_offsets")
                  if k in batch}
            with torch.inference_mode():
                if name == "wires":
                    # the model's forward plus the wires' work on the card:
                    # the crops, the u8 normalisation, the f16 cast
                    def fwd():
                        img = gen._device_crops(batch["image_origin"])
                        return gen._forward_impl(up["points"], up["point_mask"], img,
                                                 up["cell"], up.get("cell_offsets"))
                else:
                    def fwd():
                        return vmodel(up["points"], up["point_mask"], up["image"], None,
                                      up.get("cell_offsets"), footprint=False)
                fwd_ms = cuda_ms(fwd, iters=3, warmup=1)
            warm = gen.generate_dsm(os.path.join(tmp, "warmup.tif"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runtime.reset_launches()
            r = gen.generate_dsm(os.path.join(tmp, f"{name}.tif"))
            torch.cuda.synchronize()
            launches = dict(runtime.LAUNCHES)
            repeat = np.array_equal(warm.data, r.data, equal_nan=True)
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
                f"bit-equal to its warm-up run {repeat} | launches per forward "
                f"{({k: v / n_batches for k, v in launches.items() if v})}")
            if launches != want:
                raise AssertionError(f"{name}: launch counts {launches}, expected {want}")
            # every path adds in a fixed order: the kernels, and the unsorted
            # paths' plain segment ops and gathers (ops/scatter.py)
            if not repeat:
                raise AssertionError(f"two runs of the fusion {name} path gave different "
                                     "rasters")
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
    # the wires against the f32 wires on the same kernel path, within the JAX
    # package's bounds for them: the u16 quantization moves a point across a
    # cell edge now and then, so its bound is on the distribution
    # (tests/test_wire_cells.py:161-186: mean |d| <= 1e-3 * scale, under 0.5%
    # of the pixels past 0.05 * scale), and the f16 raster rounds each height
    # by up to 2^-11 of it; NaN masks equal
    ref, da = out["kernels"]["raster"], out["wires"]["raster"]
    if da.shape != ref.shape or not np.array_equal(np.isnan(da), nan):
        raise AssertionError("wires: raster differs from the f32 wires in shape/NaN mask")
    d = np.abs(da[~nan] - ref[~nan])
    scale = max(1.0, float(np.abs(ref[~nan]).max()))
    r16 = scale * 2.0 ** -11
    mean, far = float(d.mean()), float((d > 0.05 * scale + r16).mean())
    log("fusion-serve", f"wires vs f32 wires raster: mean|d| {mean:.3g} m (tol "
        f"{1e-3 * scale + r16:.3g} m), max|d| {float(d.max()):.3g} m, pixels past "
        f"{0.05 * scale + r16:.3g} m {far:.3g} (tol 5e-3)")
    if mean > 1e-3 * scale + r16 or far >= 5e-3:
        raise AssertionError(f"wires raster off the f32 wires: mean {mean}, far {far}")
    total: dict = {}
    for name in ("kernels", "fast_conv", "wires"):
        for k, v in out[name]["launches"].items():
            total[k] = total.get(k, 0) + v
    return _nonzero(total)


# kernel launches per batch-8 forward on the 'fused' path (K9 at the eight
# round trips, all at reso >= 32; K10 at the four poolings; K12 at the plane
# and the eight round trips) and on 'pallas' with max pooling (K11 at the nine
# scatters); 'cumsum' launches none. 'pallas' with mean pooling adds K13 at
# the four poolings.
SORTED_LAUNCHES = {"fused": {"tile_gather": 8, "tile_pool": 4,
                             "aligned_scatter_mean_plane": 9},
                   "pallas": {"scatter_mean_plane": 9}, "cumsum": {}}
PALLAS_MEAN_LAUNCHES = {"scatter_mean_plane": 9, "scatter_mean": 4}


def _city(seed: int):
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city

    w, h = CITY["W"], CITY["H"]
    _, pts, _ = build_city(seed, **CITY)
    return [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
             "points": pts}]


def _serve_sorted(cfg, state, chunks, tmp: str, label: str):
    """The city served on the sorted layout of ``cfg`` with weights
    ``state``: the forward of the first batch timed (median of 3), then a
    warm-up and a timed ``generate_dsm``. Returns the timed run's raster
    (and the warm-up's), its stats, forward ms, peak memory, launches and
    batches, and the first batch's forward arguments."""
    import torch

    from tomosar2height_tpu_torch.infer.generator import make_generator
    from tomosar2height_tpu_torch.models import build_model
    from tomosar2height_tpu_torch.ops.cuda import runtime

    model = build_model(cfg, DEVICE)
    model.load_state_dict(state)
    gen = make_generator(model.eval(), cfg, chunks)
    n_batches = len(gen.data_loader)
    batch = next(iter(gen.data_loader))
    keys = ("points", "point_mask", "cell", "cell_offsets")
    dev = {k: torch.from_numpy(batch[k]).to(DEVICE) for k in keys}
    fwd_args = (dev["points"], dev["point_mask"], None,
                None if gen.data_loader.aligned else dev["cell"], dev["cell_offsets"])
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*fwd_args, footprint=False), iters=3, warmup=1)
    warm = gen.generate_dsm(os.path.join(tmp, f"{label}-warmup.tif"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    r = gen.generate_dsm(os.path.join(tmp, f"{label}.tif"))
    torch.cuda.synchronize()
    return {"raster": r.data, "warm": warm.data, "transform": r.transform,
            "stats": gen.last_stats, "fwd_ms": fwd_ms, "peak": torch.cuda.max_memory_allocated(),
            "launches": dict(runtime.LAUNCHES), "n_batches": n_batches, "fwd_args": fwd_args}


def _pallas_mean_batch(state, fwd_args, dtype: str):
    """One batch of 'pallas' with mean pooling (K13) in ``dtype``: its
    heights' shape, whether they are finite, and the launches."""
    import torch

    from tomosar2height_tpu_torch.config import sorted_config
    from tomosar2height_tpu_torch.models import build_model
    from tomosar2height_tpu_torch.ops.cuda import runtime

    mcfg = sorted_config("pallas")
    mcfg["model"]["encoder_kwargs"]["scatter_type"] = "mean"
    mcfg["model"]["dtype"] = dtype
    mean_model = build_model(mcfg, DEVICE)
    mean_model.load_state_dict(state)
    runtime.reset_launches()
    with torch.inference_mode():
        h = mean_model.eval()(*fwd_args, footprint=False)[0]
    torch.cuda.synchronize()
    return tuple(h.shape), bool(torch.isfinite(h).all()), _nonzero(runtime.LAUNCHES)


def _serve_line(impl: str, s: dict) -> str:
    stats = s["stats"]
    return (f"{impl}: {stats['n_patches']} tiles in {s['n_batches']} batches "
            f"| {stats['patches_per_s']:.2f} tiles/s ({stats['total_s']:.3f} s: loader "
            f"{stats['loader_s']:.3f} dispatch {stats['dispatch_s']:.3f} wait "
            f"{stats['fetch_wait_s']:.3f} blend {stats['blend_cpu_s']:.3f} write "
            f"{stats['finalize_write_s']:.3f}) | forward {s['fwd_ms']:.1f} ms per batch "
            f"(median of 3) | peak {s['peak'] / 2**30:.2f} GiB")


def sorted_serve(seed: int = 0):
    """The synthetic city served with ``sorted_config('fused')``, ``('pallas')``
    and ``('cumsum')`` on one set of random weights, each raster held to the
    unsorted plain path's; launches per forward asserted (SORTED_LAUNCHES),
    and one batch of 'pallas' with mean pooling (K13). Returns the launches,
    the weights and each layout's timed run (``_serve_sorted``), which the
    bf16 phase serves again in bf16."""
    import tempfile

    import torch

    from tomosar2height_tpu_torch.config import sorted_config
    from tomosar2height_tpu_torch.infer.generator import make_generator
    from tomosar2height_tpu_torch.models import build_model, init_weights

    chunks = _city(seed)
    plain_cfg = sorted_config("cumsum")
    plain_cfg["dataset"]["points"]["sort"] = False
    plain = init_weights(build_model(plain_cfg, DEVICE), torch.Generator().manual_seed(seed))
    state = plain.state_dict()
    tol = _height_tol(plain_cfg)
    launches_all, served = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = make_generator(plain.eval(), plain_cfg, chunks).generate_dsm(
            os.path.join(tmp, "plain.tif"))
        nan = np.isnan(ref.data)
        if nan.all():
            raise AssertionError("the plain raster is all NaN")
        for impl, per_batch in SORTED_LAUNCHES.items():
            s = served[impl] = _serve_sorted(sorted_config(impl), state, chunks, tmp, impl)
            launches, n_batches = s["launches"], s["n_batches"]
            want = {k: per_batch.get(k, 0) * n_batches for k in launches}
            da = s["raster"]
            same = (da.shape == ref.data.shape and s["transform"] == ref.transform
                    and np.array_equal(np.isnan(da), nan))
            err = float(np.abs(da[~nan] - ref.data[~nan]).max()) if same else float("inf")
            log("sorted-serve", f"{_serve_line(impl, s)} | raster vs plain max|d| "
                f"{err:.3g} m (tol {tol:.3g} m), NaN px {int(nan.sum())} | launches per "
                f"forward {({k: v / n_batches for k, v in launches.items() if v})}")
            if not same or err > tol:
                raise AssertionError(f"{impl}: raster differs from plain ({err} m)")
            if launches != want:
                raise AssertionError(f"{impl}: launch counts {launches}, expected {want}")
            launches_all.update({k: v for k, v in launches.items() if v})
            if impl == "pallas":
                shape, finite, got = _pallas_mean_batch(state, s["fwd_args"], "float32")
                log("sorted-serve", f"pallas, scatter_type=mean: one batch, heights {shape} "
                    f"finite {finite} | launches {got}")
                if got != PALLAS_MEAN_LAUNCHES or not finite:
                    raise AssertionError(f"pallas mean: launches {got}, expected "
                                         f"{PALLAS_MEAN_LAUNCHES}")
                launches_all["scatter_mean"] = got.get("scatter_mean", 0)
            del s["fwd_args"]
    return {"launches": launches_all, "state": state, "served": served}


def munich_depth6(seed: int = 0):
    """One batch-8 fused2 forward of the flagship with the munich dataset's
    ALTO depth 6 (conf/dataset/munich.yaml): its first up level runs K4 at
    (R, F, Fl) = (32, 512, 1024). Held to the unsorted plain path; K4 runs at
    the nine round trips at reso >= 32."""
    import torch

    from tomosar2height_tpu_torch.config import flagship_config
    from tomosar2height_tpu_torch.models import build_model, init_weights
    from tomosar2height_tpu_torch.ops.cuda import runtime

    cfg = flagship_config()
    cfg["model"]["encoder_kwargs"]["unet_kwargs"]["depth"] = 6
    model = init_weights(build_model(cfg, DEVICE), torch.Generator().manual_seed(seed)).eval()
    pts, mask, apts, amask, _, toff = flagship_batch(seed + 2)
    up = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    runtime.reset_launches()
    with torch.inference_mode():
        h, _ = model(up(apts), up(amask), None, None, up(toff))
        torch.cuda.synchronize()
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        h_plain, _ = model(up(pts), up(mask))
        ms = cuda_ms(lambda: model(up(apts), up(amask), None, None, up(toff)), iters=3,
                     warmup=1)
    side = cfg["model"]["decoder_pixel_kwargs"]["output_size"]
    err = float((h - h_plain).abs().max())
    tol = _height_tol(cfg)
    log("munich-depth6", f"fused2 vs plain heights {tuple(h.shape)}: max|d| {err:.3g} m "
        f"(tol {tol:.3g} m) | forward {ms:.1f} ms (median of 3) | launches {launches}")
    if h.shape != (len(pts), side, side, 1) or not torch.isfinite(h).all() or err > tol:
        raise AssertionError(f"munich depth 6: heights differ by {err} m")
    if launches.get("fused_level") != 9:
        raise AssertionError(f"munich depth 6: launches {launches}, expected K4 9")


# kernel launches of one fused2 training mini-step with remat: the encoder's
# forward (pool2's run kernel 4, K3 1, K4 8, each with its run scatter) runs
# twice, the second time recomputed in the backward; the backward adds the
# max-pools' run kernel (4, ``pool2_bwd``), the plane scatter's K2 (1, counted
# as ``pool_gather`` and ``scatter_plane2_bwd``) and K5 at the eight levels (a
# row pass, the d_plane pass and three weight-gradient reductions each)
TRAIN_LAUNCHES = {"pool2": 8, "pool2_bwd": 4, "pool_gather": 1, "scatter_plane2": 2,
                  "fused_level": 16, "fused_level_scatter": 16, "fused_level_bwd": 8,
                  "level_d_plane": 8, "level_bwd_reduce": 24, "scatter_plane2_bwd": 1}


# mini-steps an optimizer step in phase "train": half the flagship's 8, to
# keep the smoke's time (phase "sorted-train" keeps 8)
TRAIN_OPTIMIZE_EVERY = 4


def train_phase(seed: int = 0):
    """The flagship training step on random patches of the synthetic city,
    fused2 kernel path against the unsorted plain path from the same weights
    on the same patches: 1 warm-up and 1 timed optimizer step each. Then
    the fused2 path once more, as it ran the first time: its parameters and
    window losses must come out bit-equal to the first run's (every kernel
    adds in a fixed order and the step keeps cuDNN deterministic)."""
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
    tcfg["optimize_every"] = TRAIN_OPTIMIZE_EVERY
    bsz, k = tcfg["batch_size"], tcfg["optimize_every"]
    reso = cfg["model"]["encoder_kwargs"]["plane_resolution"]
    state0 = {n: v.detach().clone() for n, v in model.state_dict().items()}
    runs = {}
    for name, sort in (("fused2", True), ("plain", False), ("fused2 again", True)):
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
        out = train(trainer, sched, loader, tcfg, max_iteration=1)
        wall = time.perf_counter() - t0
        launches = dict(runtime.LAUNCHES)
        losses = [r["loss"] for r in warm["windows"] + out["windows"]]
        moved = any(not torch.equal(v, state0[n]) for n, v in model.state_dict().items())
        runs[name] = {"state": {n: v.detach().clone() for n, v in model.state_dict().items()},
                      "losses": losses, "ms": out["median_step_ms"],
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
    fused, plain, again = runs["fused2"], runs["plain"], runs["fused2 again"]
    tol = _height_tol(cfg)
    # run-to-run determinism: every kernel writes each output once in a fixed
    # order, and the step keeps cuDNN to deterministic algorithms
    diff = {n: float((again["state"][n].double() - v.double()).abs().max())
            for n, v in fused["state"].items() if v.is_floating_point()}
    unequal = [n for n, v in fused["state"].items() if not torch.equal(again["state"][n], v)]
    err_again = max(abs(a - b) for a, b in zip(fused["losses"], again["losses"]))
    by_module: dict = {}
    for n in unequal:
        key = ".".join(n.split(".")[:2])
        by_module[key] = by_module.get(key, 0) + 1
    log("train", f"determinism: fused2 run twice from the same weights on the same patches: "
        f"parameters bit-equal {not unequal} ({len(unequal)} of {len(diff)} tensors differ, "
        f"largest max|d| {max(diff.values()):.3g}) | window losses equal "
        f"{fused['losses'] == again['losses']} (max|d| {err_again:.3g} m) | differing "
        f"tensors by module {by_module}")
    if unequal or fused["losses"] != again["losses"]:
        raise AssertionError(f"two fused2 runs differ: {len(unequal)} tensors, window losses "
                             f"by {err_again} m")
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain path launched kernels: {plain['launches']}")
    want = {**dict.fromkeys(fused["launches"], 0),
            **{key: v * fused["n"] for key, v in TRAIN_LAUNCHES.items()}}
    per_step = {key: v / fused["n"] for key, v in fused["launches"].items()}
    # the L1 loss moves by at most the heights' own difference: the model
    # phase's bound
    err = max(abs(a - b) for a, b in zip(fused["losses"], plain["losses"]))
    log("train", f"fused2 vs plain window losses: max|d| {err:.3g} m (tol {tol:.3g} m) | "
        f"mini-step fused2 {fused['ms']:.1f} ms, plain {plain['ms']:.1f} ms | launches per "
        f"fused2 mini-step {per_step}")
    if err > tol:
        raise AssertionError(f"fused2 and plain window losses differ by {err} m")
    if fused["launches"] != want:
        raise AssertionError(f"launch counts {fused['launches']}, expected {want}")
    return fused["launches"]


# kernel launches of one training mini-step on the 'fused' layout with remat:
# the encoder's forward (K10 at the four poolings, K12 at the plane and the
# eight round trips, K9 at the eight samples) runs twice, the second time
# recomputed in the backward; the backward runs each one's backward once: K9's
# on K5's d_plane pass (counted as ``level_d_plane`` too), K10's on the run
# kernel, K12's on K2 alone (counted as ``pool_gather`` too)
SORTED_TRAIN_LAUNCHES = {"tile_gather": 16, "tile_pool": 8, "aligned_scatter_mean_plane": 18,
                         "tile_gather_bwd": 8, "level_d_plane": 8, "tile_pool_bwd": 4,
                         "aligned_scatter_mean_plane_bwd": 9, "pool_gather": 9}
# ... and of one 'cumsum' mini-step: its samples' backward, K5's d_plane pass
# at the eight round trips (``ops/fused.sorted_sample``); the rest is torch
CUMSUM_TRAIN_LAUNCHES = {"level_d_plane": 8}
# the same in bf16 (``model.dtype=bfloat16``): every kernel at its bf16
# instance, no f32 launch; 'cumsum''s samples come back f32 (JAX promotes
# them), so their backward is the d_plane pass from f32 into bf16
SORTED_BF16_LAUNCHES = {impl: {f"{k}_bf16": v for k, v in per.items()}
                        for impl, per in SORTED_LAUNCHES.items()}
PALLAS_MEAN_BF16_LAUNCHES = {f"{k}_bf16": v for k, v in PALLAS_MEAN_LAUNCHES.items()}
SORTED_TRAIN_BF16_LAUNCHES = {f"{k}_bf16": v for k, v in SORTED_TRAIN_LAUNCHES.items()}
CUMSUM_TRAIN_BF16_LAUNCHES = {"level_d_plane_wide_bf16": 8}


def _differing(a: dict, b: dict) -> list:
    """Names of the tensors of two state dicts that are not bit-equal."""
    import torch

    return [n for n, v in a.items() if not torch.equal(b[n], v)]


def _sorted_train_config(impl: str, dtype: str = "float32"):
    """``sorted_config(impl)`` with flip/rotate augmentation, in ``dtype``."""
    from tomosar2height_tpu_torch.config import sorted_config

    cfg = sorted_config(impl)
    cfg["training"]["augmentation"]["flip"] = cfg["training"]["augmentation"]["rotate"] = True
    cfg["model"]["dtype"] = dtype
    return cfg


def _sorted_train_data(seed: int):
    """The city's chunks and its nDSM as the training target."""
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import RasterData

    w, h = CITY["W"], CITY["H"]
    ndsm, pts, _ = build_city(seed, **CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    return chunks, (ndsm, RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0)))


def _sorted_run(cfg, model, state0, data, sort: bool, steps: int, seed: int):
    """``steps`` optimizer steps of ``model`` (its layout's: ``cfg``; the
    unsorted plain path unless ``sort``) from ``state0`` on the city's random
    patches with augmentation, the last one timed: window losses, the state
    after the first step (two steps or more) and at the end, mini-step ms,
    train patches/s, peak memory and the timed step's launches."""
    import torch

    from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset, tile_cells_for_impl
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.train import Trainer, build_scheduler, train

    chunks, dsm = data
    tcfg, dcfg = cfg["training"], cfg["dataset"]
    bsz, k = tcfg["batch_size"], tcfg["optimize_every"]
    reso = cfg["model"]["encoder_kwargs"]["plane_resolution"]
    impl = cfg["model"]["encoder_kwargs"]["sorted_impl"]
    aug = tcfg["augmentation"]
    ds = SceneDataset(chunks, dcfg, random_sample=True, random_length=bsz * k, dsm=dsm,
                      flip_augm=aug["flip"], rotate_augm=aug["rotate"])
    loader = PatchLoader(ds, bsz, dcfg["points"]["bucket_sizes"],
                         fixed_bucket=dcfg["points"]["train_bucket"],
                         sort_reso=reso if sort else None, aligned=impl == "fused",
                         tile_cells=tile_cells_for_impl(impl), shuffle=True,
                         drop_last=True, seed=seed, det_stream=True,
                         prefetch=cfg["dataloader"]["prefetch"])
    model.load_state_dict(state0)
    trainer = Trainer(model, tcfg)
    sched = build_scheduler(tcfg)
    windows, first = [], None
    if steps > 1:
        windows += train(trainer, sched, loader, tcfg, max_iteration=1)["windows"]
        first = {n: v.detach().clone() for n, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.perf_counter()
    out = train(trainer, sched, loader, tcfg, max_iteration=1)
    wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    windows += out["windows"]
    return {"state": {n: v.detach().clone() for n, v in model.state_dict().items()},
            "first": first, "losses": [r["loss"] for r in windows],
            "ms": out["median_step_ms"],
            "patches_s": out["n_patches"] / wall, "n": out["n_ministeps"],
            "patches": out["n_patches"], "wall": wall,
            "peak": torch.cuda.max_memory_allocated(), "launches": launches}


def sorted_train(seed: int = 0):
    """The flagship trained on the 'fused' layout with flip/rotate
    augmentation (``sorted_config('fused')``, ``training.augmentation`` on),
    batch 8, ``optimize_every`` 8, det_stream, the loader's prefetch thread:
    a warm-up and a timed optimizer step; the first step again from the same
    weights on the unsorted plain path (the same patches and augmentation
    draws: window losses within 2e-4 * z_scale) and on 'fused' once more:
    every parameter and the window loss bit-equal to the first run's after
    its first step. Then one 'cumsum' step and its rerun, bit-equal too (its
    segment sums and gather-backs differentiate in a fixed order, its samples
    on K5's d_plane pass; the differing tensors are counted), and 'pallas'
    refused by ``cli.train`` in a child process that runs beside the steps
    (its scatter-means are forward-only, as the JAX kernel has no gradient;
    the model's refusal is ``tests/test_torch_cuda.py``'s)."""
    import torch

    from tomosar2height_tpu_torch.models import build_model, init_weights

    models, state0 = {}, None
    for impl in ("fused", "cumsum"):
        cfg = _sorted_train_config(impl)
        models[impl] = (cfg, build_model(cfg, DEVICE))
        if state0 is None:
            init_weights(models[impl][1], torch.Generator().manual_seed(seed))
            state0 = {n: v.detach().clone() for n, v in models[impl][1].state_dict().items()}
    cfg = models["fused"][0]
    data = _sorted_train_data(seed)

    def run(impl, sort, steps):
        return _sorted_run(*models[impl], state0, data, sort, steps, seed)

    # the refusal runs beside the steps: a process of its own, since the
    # smoke holds no exception handler
    refusal = subprocess.Popen(
        [sys.executable, "-m", "tomosar2height_tpu_torch.cli.train", "dataset=berlin",
         "dataset.points.sort=true", "model.encoder_kwargs.sorted_impl=pallas"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {}
    for name, impl, sort, steps in (("fused", "fused", True, 2), ("plain", "fused", False, 1),
                                    ("fused again", "fused", True, 1),
                                    ("cumsum", "cumsum", True, 1),
                                    ("cumsum again", "cumsum", True, 1)):
        r = runs[name] = run(impl, sort, steps)
        moved = any(not torch.equal(v, state0[n]) for n, v in r["state"].items())
        log("sorted-train", f"{name}: window losses {[f'{x:.6f}' for x in r['losses']]} | "
            f"mini-step {r['ms']:.1f} ms (median of {r['n']}, CUDA events) | "
            f"{r['patches']} patches in {r['wall']:.3f} s = {r['patches_s']:.2f} train "
            f"patches/s | peak {r['peak'] / 2**30:.2f} GiB | parameters moved {moved}")
        if not all(np.isfinite(r["losses"])) or not moved:
            raise AssertionError(f"{name}: losses {r['losses']}, parameters moved {moved}")
    fused, plain, again = runs["fused"], runs["plain"], runs["fused again"]
    unequal = _differing(fused["first"], again["state"])
    cumsum_unequal = _differing(runs["cumsum"]["state"], runs["cumsum again"]["state"])
    err = max(abs(a - b) for a, b in zip(fused["losses"], plain["losses"]))
    tol = _height_tol(cfg)
    per_step = {key: v / fused["n"] for key, v in fused["launches"].items() if v}
    log("sorted-train", f"determinism: fused run twice from the same weights on the same "
        f"patches: {len(unequal)} of {len(fused['state'])} tensors differ after the first "
        f"step, window losses equal {fused['losses'][:1] == again['losses']} | cumsum run "
        f"twice: {len(cumsum_unequal)} of {len(fused['state'])} tensors differ "
        f"({sorted(cumsum_unequal)[:6]}), window losses equal "
        f"{runs['cumsum']['losses'] == runs['cumsum again']['losses']} | fused vs plain "
        f"window losses max|d| {err:.3g} m (tol {tol:.3g} m) | mini-step fused "
        f"{fused['ms']:.1f} ms, plain {plain['ms']:.1f} ms, cumsum {runs['cumsum']['ms']:.1f} "
        f"ms | launches per fused mini-step {per_step}")
    if unequal or fused["losses"][:1] != again["losses"]:
        raise AssertionError(f"two fused runs differ: {len(unequal)} tensors")
    if cumsum_unequal or runs["cumsum"]["losses"] != runs["cumsum again"]["losses"]:
        raise AssertionError(f"two cumsum runs differ: {len(cumsum_unequal)} tensors")
    if err > tol:
        raise AssertionError(f"fused and plain window losses differ by {err} m")
    if any(plain["launches"].values()):
        raise AssertionError(f"the plain path launched kernels: {plain['launches']}")
    cumsum_want = {**dict.fromkeys(runs["cumsum"]["launches"], 0),
                   **{key: v * runs["cumsum"]["n"] for key, v in CUMSUM_TRAIN_LAUNCHES.items()}}
    if runs["cumsum"]["launches"] != cumsum_want:
        raise AssertionError(f"cumsum launch counts {runs['cumsum']['launches']}, expected "
                             f"{cumsum_want}")
    want = {**dict.fromkeys(fused["launches"], 0),
            **{key: v * fused["n"] for key, v in SORTED_TRAIN_LAUNCHES.items()}}
    if fused["launches"] != want:
        raise AssertionError(f"launch counts {fused['launches']}, expected {want}")
    # 'pallas' does not train: the entry point refuses the layout
    _, err = refusal.communicate(timeout=300)
    said = err.strip().splitlines()[-1:]
    log("sorted-train", f"pallas refused by cli.train: exit {refusal.returncode}, {said}")
    if refusal.returncode == 0 or "no gradient either" not in str(said):
        raise AssertionError(f"cli.train did not refuse pallas: {refusal.returncode} {said}")
    keep = ("losses", "ms", "patches_s", "peak")
    return {"launches": fused["launches"], "state0": state0,
            "f32": {impl: {k: runs[impl][k] for k in keep} for impl in ("fused", "cumsum")}}


# kernel launches of one headline training mini-step (``headline_config``:
# fused2 + fused_convs + fused_head, ALTO depth 6, the footprint head), with
# remat: the encoder's forward (pool2's run kernel 4, K3 1, K4 at the nine
# round trips at reso >= 32, each with its run scatter, K7 at the 11 ALTO
# conv pairs) runs twice, the second time recomputed in the backward; the
# image U-Net's 11 conv pairs (K7) once, K6 for the height and the footprint
# heads; the backward adds pool2's backward (4), K2 for the plane scatter and
# K5 at the nine levels (a row pass, the d_plane pass and three weight sums
# each). K6's and K7's backwards are the plain composition's: no launch.
HEADLINE_TRAIN_LAUNCHES = {"pool2": 8, "pool2_bwd": 4, "pool_gather": 1, "scatter_plane2": 2,
                           "fused_level": 18, "fused_level_scatter": 18,
                           "fused_level_bwd": 9, "level_d_plane": 9, "level_bwd_reduce": 27,
                           "scatter_plane2_bwd": 1, "conv_pair": 33, "conv_decoder": 2}


def _footprint_tol(cfg) -> float:
    """loss_ce moves by at most weight_ce x the footprint logits' own
    difference (the BCE is 1-Lipschitz in the logit), held at the JAX
    package's 2e-4 on logits (tests/test_fused_model.py:73)."""
    return 2e-4 * cfg["training"]["weight_ce"]


def headline_unsorted(dtype: str, fused: bool = True):
    """``headline_config()`` on the unsorted point path in ``dtype``
    (``model.dtype``), the conv kernel flags (K6, K7) kept or, without
    ``fused``, off."""
    from tomosar2height_tpu_torch.config import headline_config

    cfg = headline_config()
    cfg["dataset"]["points"]["sort"] = False
    cfg["model"]["dtype"] = dtype
    if not fused:
        cfg["model"]["encoder_kwargs"]["unet_kwargs"]["fused_convs"] = False
        cfg["model"]["encoder2_kwargs"]["fused_convs"] = False
        cfg["model"]["decoder_pixel_kwargs"]["fused_head"] = False
    return cfg


HEADLINE_OPTIMIZE_EVERY = 4  # mini-steps an optimizer step (headline_config()'s is 8)


def _headline_parts(seed: int, kernels: bool, cfg=None):
    """The headline config (``kernels``: fused2 + K6/K7; else the unsorted
    path with the kernel flags off; or ``cfg``, unsorted), its training keys
    with a checkpoint every iteration, no validation and
    HEADLINE_OPTIMIZE_EVERY mini-steps an optimizer step, and a det_stream
    loader of one optimizer step's random patches a pass over the synthetic
    city, with the city's nDSM as target and its RGB image."""
    from tomosar2height_tpu_torch.config import headline_config
    from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import RasterData

    if cfg is None:
        cfg = headline_config() if kernels else headline_unsorted("float32", fused=False)
    w, h = CITY["W"], CITY["H"]
    ndsm, pts, rgb = build_city(seed, **CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    grid = RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0))
    tcfg = {**cfg["training"], "checkpoint_every": 1, "validate_every": 0,
            "optimize_every": HEADLINE_OPTIMIZE_EVERY}
    dcfg = cfg["dataset"]
    bsz = tcfg["batch_size"]
    ds = SceneDataset(chunks, dcfg, random_sample=True,
                      random_length=bsz * tcfg["optimize_every"], dsm=(ndsm, grid),
                      image=(rgb, grid))
    reso = cfg["model"]["encoder_kwargs"]["plane_resolution"]
    loader = PatchLoader(ds, bsz, dcfg["points"]["bucket_sizes"],
                         fixed_bucket=dcfg["points"]["train_bucket"],
                         sort_reso=reso if kernels else None, shuffle=True, drop_last=True,
                         seed=seed, det_stream=True)
    return cfg, tcfg, loader


def _headline_trainer(cfg, tcfg, model):
    from tomosar2height_tpu_torch.train import Trainer, build_scheduler

    trainer = Trainer(model, tcfg, use_cloud=cfg["use_cloud"], use_image=cfg["use_image"],
                      use_footprint=cfg["use_footprint"], weight_ce=tcfg["weight_ce"])
    return trainer, build_scheduler(tcfg)


def headline_resume(ckpt_path: str, out_path: str, seed: int = 0) -> None:
    """The resume half of "headline-train", run in a child process: a fresh
    network, trainer, scheduler and loader, resumed from ``ckpt_path``
    through ``train/loop.py`` up to iteration HEADLINE_STEPS; the final state dict, the
    window records and the launches go to ``out_path`` (``torch.save``)."""
    import torch

    sys.path.insert(0, REPO)
    from tomosar2height_tpu_torch.models import build_model
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.train import train
    from tomosar2height_tpu_torch.train.checkpoint import CheckpointIO

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tcfg, loader = _headline_parts(seed, True)
    model = build_model(cfg, DEVICE)  # its weights come from the checkpoint
    trainer, sched = _headline_trainer(cfg, tcfg, model)
    io = CheckpointIO(os.path.dirname(out_path))
    runtime.reset_launches()
    t0 = time.perf_counter()
    out = train(trainer, sched, loader, {**tcfg, "checkpoint_every": 0},
                max_iteration=HEADLINE_STEPS, checkpoint_io=io, resume_from=ckpt_path)
    torch.cuda.synchronize()
    torch.save({"state": {n: v.detach().cpu() for n, v in model.state_dict().items()},
                "windows": out["windows"], "resumed": out["resumed"], "n_iter": out["n_iter"],
                "launches": dict(runtime.LAUNCHES), "wall": time.perf_counter() - t0},
               out_path)


HEADLINE_STEPS = 2  # optimizer steps of each path: the warm-up and one timed


def headline_train(seed: int = 0):
    """The headline network trained at full width on the synthetic city with
    its RGB image, batch 8, ``optimize_every`` 4: the kernel path (fused2 +
    K6/K7) for HEADLINE_STEPS optimizer steps with a checkpoint after each
    (the first the warm-up, the timed run the second), launches per
    mini-step asserted; the plain path (unsorted, kernel flags off) from the
    same weights on the same patches for the first of them (its mini-step
    ms the median of that step's mini-steps after the first), its window
    losses held within ``_height_tol`` (loss_l1) and ``_footprint_tol`` (loss_ce),
    and run once more (0 tensors may differ, the window losses equal);
    the checkpoint's size and round trip; then a child process resumes from
    the iteration-1 checkpoint and runs on to iteration HEADLINE_STEPS: 0
    tensors may differ from the uninterrupted run, and the window losses
    must be equal."""
    import gc
    import tempfile

    import torch

    from tomosar2height_tpu_torch.models import build_model, init_weights
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.train import train
    from tomosar2height_tpu_torch.train.checkpoint import CheckpointIO

    cfg, tcfg, loader = _headline_parts(seed, True)
    model = init_weights(build_model(cfg, DEVICE), torch.Generator().manual_seed(seed))
    state0 = {n: v.detach().clone() for n, v in model.state_dict().items()}
    k = tcfg["optimize_every"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        io = CheckpointIO(os.path.join(tmp, "kernels"))
        for name in ("kernels", "plain", "plain again"):
            if name != "kernels":
                pcfg, ptcfg, loader = _headline_parts(seed, False)
                model = build_model(pcfg, DEVICE)
                model.load_state_dict(state0)
            trainer, sched = _headline_trainer(cfg, tcfg, model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runtime.reset_launches()
            out = train(trainer, sched, loader, tcfg,
                        max_iteration=HEADLINE_STEPS if name == "kernels" else 1,
                        checkpoint_io=io if name == "kernels" else None)
            torch.cuda.synchronize()
            timed = out["windows"][1:] or out["windows"]
            wall = sum(w["time_loader_s"] + w["time_step_s"] + w["time_log_s"] for w in timed)
            patches = sum(w["n_patches"] for w in timed)
            runs[name] = {"windows": out["windows"], "launches": dict(runtime.LAUNCHES),
                          "ms": float(np.median(out["step_ms"][k:] or out["step_ms"][1:])),
                          "n": len(out["step_ms"]),
                          "patches_s": patches / wall, "patches": patches, "wall": wall,
                          "peak": torch.cuda.max_memory_allocated(),
                          "aux": [w["time_aux_s"] for w in out["windows"]]}
            r = runs[name]
            gn = [f"{w['grad_norm']:.4g}" for w in out["windows"]]
            log("headline-train", f"{name}: window losses "
                f"{[round(w['loss'], 6) for w in out['windows']]} (l1 "
                f"{[round(w['loss_l1'], 6) for w in out['windows']]}, ce "
                f"{[round(w['loss_ce'], 6) for w in out['windows']]}) | grad_norm "
                f"{gn} | mini-step "
                f"{r['ms']:.1f} ms (median of the timed {max(r['n'] - k, r['n'] - 1)}, CUDA "
                f"events) | {patches} patches in {wall:.3f} s = {r['patches_s']:.2f} train "
                f"patches/s (windows {'2-' if len(out['windows']) > 1 else ''}"
                f"{len(out['windows'])}, checkpoints not counted) | peak "
                f"{r['peak'] / 2**30:.2f} GiB"
                + (f" | checkpoint writes {[round(x, 3) for x in r['aux']]} s"
                   if name == "kernels" else ""))
            if not all(np.isfinite(w["loss"]) for w in out["windows"]):
                raise AssertionError(f"{name}: window losses not finite")
            if name != "kernels":
                r["state"] = {n: v.detach().clone() for n, v in model.state_dict().items()}
            if name == "kernels":
                # the round trip: the last checkpoint (its write is the last
                # window's aux time) read back into the run's objects
                final = {n: v.detach().cpu().clone() for n, v in model.state_dict().items()}
                path = os.path.join(io.checkpoint_dir, f"model_{HEADLINE_STEPS}.ckpt")
                size = os.path.getsize(path)
                t0 = time.perf_counter()
                io.load(path)
                torch.cuda.synchronize()
                read_s = time.perf_counter() - t0
                os.remove(path)
                back = [n for n, v in model.state_dict().items()
                        if not torch.equal(v.cpu(), final[n])]
                io.module_dict.clear()  # release the run's model and optimizer
                log("headline-train", f"checkpoint: {size / 2**20:.1f} MiB (model, AdamW "
                    f"state and window, scheduler), written in {r['aux'][-1]:.3f} s, read "
                    f"and loaded in {read_s:.3f} s; parameters after the round trip "
                    f"bit-equal {not back}")
                if back:
                    raise AssertionError(f"the checkpoint round trip changed {back[:4]}")
            del trainer, sched, out
        kern, plain, again = runs["kernels"], runs["plain"], runs.pop("plain again")
        if any(plain["launches"].values()) or any(again["launches"].values()):
            raise AssertionError(f"the plain path launched kernels: {plain['launches']}")
        # the unsorted plain path's first step twice from the same weights on
        # the same patches: its segment ops and gathers add in a fixed order
        unequal = _differing(plain.pop("state"), again.pop("state"))
        keys = ("loss", "loss_l1", "loss_ce")
        same = ([[w[k] for k in keys] for w in plain["windows"]]
                == [[w[k] for k in keys] for w in again["windows"]])
        log("headline-train", f"plain (unsorted) first step run twice from the same weights "
            f"on the same patches: {len(unequal)} of {len(final)} tensors differ "
            f"{unequal[:4]}, window losses equal {same} | mini-step {plain['ms']:.1f} / "
            f"{again['ms']:.1f} ms")
        if unequal or not same:
            raise AssertionError(f"the unsorted f32 rerun differs: {len(unequal)} tensors "
                                 f"{unequal[:4]}, window losses equal {same}")
        want = {**dict.fromkeys(kern["launches"], 0),
                **{key: v * kern["n"] for key, v in HEADLINE_TRAIN_LAUNCHES.items()}}
        per_step = {key: v / kern["n"] for key, v in kern["launches"].items() if v}
        tol, tol_ce = _height_tol(cfg), _footprint_tol(cfg)
        err = max(abs(a["loss_l1"] - b["loss_l1"])
                  for a, b in zip(kern["windows"], plain["windows"]))
        err_ce = max(abs(a["loss_ce"] - b["loss_ce"])
                     for a, b in zip(kern["windows"], plain["windows"]))
        log("headline-train", f"kernels vs plain window losses: loss_l1 max|d| {err:.3g} m "
            f"(tol {tol:.3g} m), loss_ce max|d| {err_ce:.3g} (tol {tol_ce:.3g}) | mini-step "
            f"kernels {kern['ms']:.1f} ms, plain {plain['ms']:.1f} ms | launches per kernel "
            f"mini-step {per_step}")
        if err > tol or err_ce > tol_ce:
            raise AssertionError(f"kernel and plain window losses differ: loss_l1 {err}, "
                                 f"loss_ce {err_ce}")
        if kern["launches"] != want:
            raise AssertionError(f"launch counts {kern['launches']}, expected {want}")
        # the resume, in a process of its own: no cuDNN plan or allocator
        # state carries over
        del model
        gc.collect()
        torch.cuda.empty_cache()
        child_out = os.path.join(tmp, "child", "final.pt")
        os.makedirs(os.path.dirname(child_out))
        code = (f"import chip_smoke; chip_smoke.headline_resume("
                f"{os.path.join(io.checkpoint_dir, 'model_1.ckpt')!r}, {child_out!r}, {seed})")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                           text=True, timeout=900)
        child_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"the resume process failed ({r.returncode}): "
                                 f"{r.stderr[-3000:]}")
        child = torch.load(child_out)
    differ = [n for n, v in final.items() if not torch.equal(child["state"][n], v)]
    keys = ("loss", "loss_l1", "loss_ce")
    got = [[w[key] for key in keys] for w in child["windows"]]
    ref = [[w[key] for key in keys] for w in kern["windows"][1:]]
    log("headline-train", f"resume in a child process from the iteration-1 checkpoint "
        f"({child_s:.1f} s, iterations {[w['iteration'] for w in child['windows']]}): "
        f"{len(differ)} of {len(final)} tensors differ from the uninterrupted run | window "
        f"losses of iterations 2-{HEADLINE_STEPS} equal {got == ref}")
    if (not child["resumed"] or child["n_iter"] != HEADLINE_STEPS or differ or got != ref
            or sorted(child["state"]) != sorted(final)):
        raise AssertionError(f"the resumed run differs: {len(differ)} tensors "
                             f"({differ[:4]}), window losses {got} vs {ref}")
    return {"launches": {key: kern["launches"][key] for key in ("conv_pair", "conv_decoder")},
            **{key: kern[key] for key in ("windows", "ms", "patches_s", "peak")}}


# kernel launches per batch-8 forward of the headline network in bf16: on
# fused2 (K1-K4 at their bf16 instances: pool2 4, scatter_plane2 1, K4 and
# its plane at the nine levels of 32^2 and more) with the conv kernels' flags,
# 11 ALTO and 11 image U-Net conv pairs (K7) and the height decoder (K6;
# serving skips the footprint head); on the unsorted path with the flags off
# under FAST_CONV its 47 Conv3x3 (K8): 46 on its wgmma route, the image
# U-Net's first (Cin 3) on the flat-K route; the 44 convs of its 22 pairs
# (K7) likewise, 43 on the wgmma route and the Cin 3 one flat. Per training
# mini-step on fused2 HEADLINE_TRAIN_LAUNCHES' kernels at their bf16
# instances (remat's recompute doubles the point encoder's, whose ALTO
# U-Net's 11 pairs all take the wgmma route); K6's three convs a launch
# all on the wgmma route, the head in the third's epilogue.
BF16_SERVE_LAUNCHES = {"pool2_bf16": 4, "scatter_plane2_bf16": 1, "fused_level_bf16": 9,
                       "fused_level_scatter_bf16": 9, "conv_pair_bf16": 22,
                       "conv_pair_bf16_wgmma": 43, "conv_pair_bf16_flat": 1,
                       "conv_decoder_bf16": 1, "conv_decoder_bf16_wgmma": 3}
BF16_FAST_CONV_LAUNCHES = {"conv3x3_bf16": 47, "conv3x3_bf16_wgmma": 46,
                           "conv3x3_bf16_flat": 1}
BF16_TRAIN_LAUNCHES = {**{f"{k}_bf16": v for k, v in HEADLINE_TRAIN_LAUNCHES.items()},
                       "conv_pair_bf16_wgmma": 2 * HEADLINE_TRAIN_LAUNCHES["conv_pair"] - 1,
                       "conv_pair_bf16_flat": 1,
                       "conv_decoder_bf16_wgmma": 3 * HEADLINE_TRAIN_LAUNCHES["conv_decoder"]}


def _f32_launches(counts: dict) -> dict:
    return {k.replace("_bf16", ""): v for k, v in counts.items()}


def headline_bf16(sort: bool = True):
    """``headline_config()`` in bf16 (``model.dtype=bfloat16``): on its
    fused2 kernel path, or with ``sort`` False on the unsorted point path
    with the conv kernel flags off."""
    from tomosar2height_tpu_torch.config import headline_config

    cfg = headline_config() if sort else headline_unsorted("bfloat16", fused=False)
    cfg["model"]["dtype"] = "bfloat16"
    return cfg


def sorted_bf16(serve_f32: dict, train_f32: dict, seed: int = 0):
    """The sorted layouts in bf16 (``model.dtype=bfloat16``) from the f32
    phases' weights:

    - serving the city on 'fused' (K9, K10, K12 at their bf16 instances),
      'pallas' (K11; K13 on one batch with mean pooling) and 'cumsum' (no
      kernel) with sorted-serve's weights: a warm-up and a timed
      ``generate_dsm`` each, bit-equal, launches asserted
      (SORTED_BF16_LAUNCHES: no f32 launch), each raster against
      sorted-serve's f32 raster on the same layout within the JAX package's
      bf16 gate (max |d| <= 0.15 x scale, correlation > 0.99), NaN masks
      equal; tiles/s, forward ms and peak memory beside f32's;
    - training on 'fused' (K9, K10, K12 and their backwards at their bf16
      instances) and 'cumsum' (its samples' backward on K5's d_plane pass
      from f32 into bf16) with sorted-train's weights, augmentation and
      patches: a warm-up and a timed optimizer step (launches per mini-step
      asserted, no f32 launch), window losses within 0.15 x scale of
      sorted-train's f32 windows, then the first step rerun from the same
      weights: every parameter and the window loss bit-equal.

    Returns the bf16 kernels' launches of the timed runs."""
    import tempfile

    from tomosar2height_tpu_torch.config import sorted_config
    from tomosar2height_tpu_torch.models import build_model

    chunks, total = _city(seed), {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl, per_batch in SORTED_BF16_LAUNCHES.items():
            cfg = sorted_config(impl)
            cfg["model"]["dtype"] = "bfloat16"
            s = _serve_sorted(cfg, serve_f32["state"], chunks, tmp, f"{impl}-bf16")
            f32 = serve_f32["served"][impl]
            ref, da = f32["raster"], s["raster"]
            nan = np.isnan(ref)
            scale = max(1.0, float(np.abs(ref[~nan]).max()))
            if da.shape != ref.shape or not np.array_equal(np.isnan(da), nan):
                raise AssertionError(f"{impl} bf16: raster differs from f32 in shape or NaN mask")
            d = np.abs(da[~nan] - ref[~nan])
            corr = float(np.corrcoef(da[~nan], ref[~nan])[0, 1])
            again = np.array_equal(s["warm"], da, equal_nan=True)
            n_batches = s["n_batches"]
            log("bf16", f"serve {_serve_line(impl, s)} (f32 "
                f"{f32['stats']['patches_per_s']:.2f} tiles/s, forward {f32['fwd_ms']:.1f} ms, "
                f"peak {f32['peak'] / 2**30:.2f} GiB) | bit-equal to its warm-up run {again} | "
                f"vs f32 raster max|d| {float(d.max()):.4g} m (tol {0.15 * scale:.4g} m = "
                f"0.15 x scale {scale:.4g} m), mean|d| {float(d.mean()):.4g} m, correlation "
                f"{corr:.6f} (tol > 0.99) | launches per forward "
                f"{({k: v / n_batches for k, v in s['launches'].items() if v})}")
            want = {k: per_batch.get(k, 0) * n_batches for k in s["launches"]}
            if s["launches"] != want:
                raise AssertionError(f"{impl} bf16: launch counts {s['launches']}, expected "
                                     f"{want}")
            if not again:
                raise AssertionError(f"{impl} bf16: the timed raster differs from the warm-up's")
            if d.max() > 0.15 * scale or corr <= 0.99:
                raise AssertionError(f"{impl} bf16 raster off the f32 raster: {d.max()} m, "
                                     f"corr {corr}")
            for k, v in s["launches"].items():
                total[k] = total.get(k, 0) + v
            if impl == "pallas":
                shape, finite, got = _pallas_mean_batch(serve_f32["state"], s["fwd_args"],
                                                        "bfloat16")
                log("bf16", f"pallas bf16, scatter_type=mean: one batch, heights {shape} "
                    f"finite {finite} | launches {got}")
                if got != PALLAS_MEAN_BF16_LAUNCHES or not finite:
                    raise AssertionError(f"pallas bf16 mean: launches {got}, expected "
                                         f"{PALLAS_MEAN_BF16_LAUNCHES}")
                total["scatter_mean_bf16"] = got.get("scatter_mean_bf16", 0)
            del s

    data = _sorted_train_data(seed)
    ref = serve_f32["served"]["fused"]["raster"]
    scale = max(1.0, float(np.abs(ref[~np.isnan(ref)]).max()))  # the f32 heights' scale
    for impl, per_step in (("fused", SORTED_TRAIN_BF16_LAUNCHES),
                           ("cumsum", CUMSUM_TRAIN_BF16_LAUNCHES)):
        cfg = _sorted_train_config(impl, "bfloat16")
        model = build_model(cfg, DEVICE)
        bf = _sorted_run(cfg, model, train_f32["state0"], data, True, 2, seed)
        rerun = _sorted_run(cfg, model, train_f32["state0"], data, True, 1, seed)
        f32 = train_f32["f32"][impl]
        err = max(abs(a - b) for a, b in zip(bf["losses"], f32["losses"]))
        unequal = _differing(bf["first"], rerun["state"])
        log("bf16", f"train {impl} bf16: window losses {[f'{x:.6f}' for x in bf['losses']]} "
            f"(f32 {[f'{x:.6f}' for x in f32['losses']]}, max|d| {err:.4g} m, tol "
            f"{0.15 * scale:.4g} m) | mini-step {bf['ms']:.1f} ms (median of {bf['n']}, CUDA "
            f"events; f32 {f32['ms']:.1f}) | {bf['patches']} patches in {bf['wall']:.3f} s = "
            f"{bf['patches_s']:.2f} train patches/s (f32 {f32['patches_s']:.2f}) | peak "
            f"{bf['peak'] / 2**30:.2f} GiB (f32 {f32['peak'] / 2**30:.2f}) | first step run "
            f"twice from the same weights on the same patches: {len(unequal)} of "
            f"{len(bf['first'])} tensors differ {unequal[:4]}, window loss equal "
            f"{bf['losses'][:1] == rerun['losses']}")
        if not all(np.isfinite(bf["losses"])) or err > 0.15 * scale:
            raise AssertionError(f"{impl} bf16: window losses {bf['losses']}, f32 "
                                 f"{f32['losses']}")
        if unequal or bf["losses"][:1] != rerun["losses"]:
            raise AssertionError(f"{impl} bf16: the rerun differs: {len(unequal)} tensors "
                                 f"{unequal[:4]}")
        want = {**dict.fromkeys(bf["launches"], 0),
                **{key: v * bf["n"] for key, v in per_step.items()}}
        if bf["launches"] != want:
            raise AssertionError(f"{impl} bf16: launch counts {bf['launches']}, expected {want}")
        for k, v in bf["launches"].items():
            total[k] = total.get(k, 0) + v
        del model, bf, rerun
    return _nonzero(total)


def bf16_phase(f32_train: dict, sorted_serve_out: dict, sorted_train_out: dict,
               seed: int = 0):
    """The headline network in bf16 (``model.dtype=bfloat16``) at full width
    on its fused2 kernel path (K1-K5 and K6/K7 at their bf16 instances),
    weights from ``seed`` as headline-train's, against the same network in
    f32 from the same weights:

    - serving the synthetic city with its RGB image: bf16 on fused2 and f32
      on fused2, each timed ``generate_dsm`` (the second) with its tiles/s,
      forward ms, peak memory and launches (asserted), the bf16 timed raster
      bit-equal to its warm-up raster; then bf16 on the unsorted path with
      the flags off under FAST_CONV (K8), its timed raster bit-equal to its
      warm-up's too; each bf16 raster against
      the f32 raster within the JAX package's
      bf16 gate (max |d| <= 0.15 x scale, correlation > 0.99;
      tests/test_bf16.py), NaN masks equal;
    - training, ``optimize_every`` HEADLINE_OPTIMIZE_EVERY: a warm-up and a
      timed optimizer step in bf16 on fused2 (launches per mini-step
      asserted), on headline-train's patches: its window losses within 0.15
      x scale of ``f32_train``'s (headline-train's kernel run: the same
      weights, patches and steps in f32; an L1 loss moves at most as far as
      the heights), mini-step ms, train patches/s and peak memory beside
      it; the bf16 first step run again from the same weights, and every
      parameter and the window loss bit-equal to the first run's; the same
      first step on the unsorted path in bf16 (``headline_unsorted``, the
      conv kernels' flags on) run twice, bit-equal, its window L1 loss
      within 0.15 x scale of f32's;
    - then the sorted layouts in bf16 (``sorted_bf16``) from the weights of
      ``sorted_serve_out`` and ``sorted_train_out``.

    Returns the bf16 kernels' launches of the timed bf16 runs."""
    import tempfile

    import torch

    from tomosar2height_tpu_torch.config import headline_config
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import RasterData
    from tomosar2height_tpu_torch.infer.generator import make_generator
    from tomosar2height_tpu_torch.models import build_model, init_weights
    from tomosar2height_tpu_torch.models.blocks import set_fast_conv
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.train import train

    w, h = CITY["W"], CITY["H"]
    _, pts, rgb = build_city(seed, **CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    image = (rgb, RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0)))
    cfgs = {"bf16": headline_bf16(), "f32": headline_config(),
            "bf16 fast_conv": headline_bf16(sort=False)}
    models = {name: build_model(cfg, DEVICE) for name, cfg in cfgs.items()}
    init_weights(models["bf16"], torch.Generator().manual_seed(seed))
    state0 = {n: v.detach().clone() for n, v in models["bf16"].state_dict().items()}
    for name in ("f32", "bf16 fast_conv"):
        models[name].load_state_dict(state0)

    served, total = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, per_batch in (("bf16", BF16_SERVE_LAUNCHES),
                                ("f32", _f32_launches(BF16_SERVE_LAUNCHES)),
                                ("bf16 fast_conv", BF16_FAST_CONV_LAUNCHES)):
            model = models[name].eval()
            set_fast_conv(name == "bf16 fast_conv")
            gen = make_generator(model, cfgs[name], chunks, image=image)
            n_batches = len(gen.data_loader)
            warm = None
            batch = next(iter(gen.data_loader))
            up = {k: torch.from_numpy(batch[k]).to(DEVICE)
                  for k in ("points", "point_mask", "image", "cell_offsets") if k in batch}
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: model(up["points"], up["point_mask"], up["image"],
                                               None, up.get("cell_offsets"),
                                               footprint=False), iters=3, warmup=1)
            warm = gen.generate_dsm(os.path.join(tmp, "warmup.tif"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runtime.reset_launches()
            r = gen.generate_dsm(os.path.join(tmp, f"{name}.tif"))
            torch.cuda.synchronize()
            launches = dict(runtime.LAUNCHES)
            set_fast_conv(False)
            stats = gen.last_stats
            served[name] = r.data
            again = np.array_equal(warm.data, r.data, equal_nan=True)
            log("bf16", f"serve {name}: {stats['n_patches']} tiles in {n_batches} batches | "
                f"{stats['patches_per_s']:.2f} tiles/s ({stats['total_s']:.3f} s) | forward "
                f"{fwd_ms:.1f} ms per batch (median of 3) | bit-equal to its warm-up run "
                f"{again} | peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
                f"launches per forward "
                f"{({k: v / n_batches for k, v in launches.items() if v})}")
            want = {k: per_batch.get(k, 0) * n_batches for k in launches}
            if launches != want:
                raise AssertionError(f"{name}: launch counts {launches}, expected {want}")
            if not again:
                raise AssertionError(f"{name}: the timed raster differs from the warm-up's")
            if name != "f32":
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            del gen, warm, r
    ref = served["f32"]
    nan = np.isnan(ref)
    if ref.shape != (h, w) or nan.all():
        raise AssertionError(f"bad f32 raster {ref.shape}")
    scale = max(1.0, float(np.abs(ref[~nan]).max()))
    for name in ("bf16", "bf16 fast_conv"):
        da = served[name]
        if da.shape != ref.shape or not np.array_equal(np.isnan(da), nan):
            raise AssertionError(f"{name}: raster differs from f32 in shape or NaN mask")
        d = np.abs(da[~nan] - ref[~nan])
        corr = float(np.corrcoef(da[~nan], ref[~nan])[0, 1])
        log("bf16", f"serve {name} vs f32 raster: max|d| {float(d.max()):.4g} m (tol "
            f"{0.15 * scale:.4g} m = 0.15 x scale {scale:.4g} m), mean|d| "
            f"{float(d.mean()):.4g} m, correlation {corr:.6f} (tol > 0.99), NaN px "
            f"{int(nan.sum())}")
        if d.max() > 0.15 * scale or corr <= 0.99:
            raise AssertionError(f"{name} raster off the f32 raster: {d.max()} m, corr {corr}")
    del models["f32"], models["bf16 fast_conv"]

    def run(steps, label):
        model = models["bf16"]
        model.load_state_dict(state0)
        cfg, tcfg, loader = _headline_parts(seed, True, cfgs["bf16"])
        trainer, sched = _headline_trainer(cfg, tcfg, model)
        windows, first = [], None
        if steps > 1:
            windows += train(trainer, sched, loader, tcfg, max_iteration=1)["windows"]
            first = {n: v.detach().clone() for n, v in model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_launches()
        t0 = time.perf_counter()
        out = train(trainer, sched, loader, tcfg, max_iteration=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        windows += out["windows"]
        r = {"first": first or {n: v.detach().clone() for n, v in model.state_dict().items()},
             "losses": [x["loss_l1"] for x in windows], "ms": out["median_step_ms"],
             "n": out["n_ministeps"], "patches": out["n_patches"], "wall": wall,
             "peak": torch.cuda.max_memory_allocated(), "launches": dict(runtime.LAUNCHES)}
        log("bf16", f"train {label}: window L1 losses {[f'{x:.6f}' for x in r['losses']]} | "
            f"mini-step {r['ms']:.1f} ms (median of {r['n']}, CUDA events) | {r['patches']} "
            f"patches in {wall:.3f} s = {r['patches'] / wall:.2f} train patches/s | peak "
            f"{r['peak'] / 2**30:.2f} GiB")
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"bf16: window losses {r['losses']}")
        return r

    bf, again = run(2, "bf16"), run(1, "bf16 again")
    f32_losses = [x["loss_l1"] for x in f32_train["windows"]]
    err = max(abs(a - b) for a, b in zip(bf["losses"], f32_losses))
    unequal = _differing(bf["first"], again["first"])
    log("bf16", f"train bf16 vs f32 (headline-train's kernel run, same weights and patches) "
        f"window L1 losses: max|d| {err:.4g} m (tol {0.15 * scale:.4g} m) | mini-step bf16 "
        f"{bf['ms']:.1f} ms, f32 {f32_train['ms']:.1f} ms | train patches/s bf16 "
        f"{bf['patches'] / bf['wall']:.2f}, f32 {f32_train['patches_s']:.2f} | peak bf16 "
        f"{bf['peak'] / 2**30:.2f} GiB, f32 {f32_train['peak'] / 2**30:.2f} GiB | bf16 first "
        f"step run twice from the same weights on the same patches: {len(unequal)} of "
        f"{len(bf['first'])} tensors differ {unequal[:4]}, window loss equal "
        f"{bf['losses'][:1] == again['losses']}")
    if err > 0.15 * scale:
        raise AssertionError(f"bf16 and f32 window losses differ by {err} m")
    if unequal or bf["losses"][:1] != again["losses"]:
        raise AssertionError(f"the bf16 rerun differs: {len(unequal)} tensors {unequal[:4]}")
    want = {**dict.fromkeys(bf["launches"], 0),
            **{key: v * bf["n"] for key, v in BF16_TRAIN_LAUNCHES.items()}}
    if bf["launches"] != want:
        raise AssertionError(f"train bf16: launch counts {bf['launches']}, expected {want}")
    for k, v in bf["launches"].items():
        total[k] = total.get(k, 0) + v
    del models, bf, again

    # the unsorted point path in bf16 (the conv kernels' flags on): its first
    # step twice from the same weights on the same patches
    ucfg = headline_unsorted("bfloat16")
    umodel = build_model(ucfg, DEVICE)

    def unsorted_run():
        umodel.load_state_dict(state0)
        cfg, tcfg, loader = _headline_parts(seed, False, ucfg)
        trainer, sched = _headline_trainer(cfg, tcfg, umodel)
        runtime.reset_launches()
        out = train(trainer, sched, loader, tcfg, max_iteration=1)
        torch.cuda.synchronize()
        return ({n: v.detach().clone() for n, v in umodel.state_dict().items()},
                [[w[k] for k in ("loss", "loss_l1", "loss_ce")] for w in out["windows"]],
                out["median_step_ms"], out["n_ministeps"], dict(runtime.LAUNCHES))

    u1, u2 = unsorted_run(), unsorted_run()
    unequal = _differing(u1[0], u2[0])
    err = abs(u1[1][0][1] - f32_losses[0])
    log("bf16", f"train bf16 unsorted (conv kernels on) first step run twice from the same "
        f"weights on the same patches: {len(unequal)} of {len(u1[0])} tensors differ "
        f"{unequal[:4]}, window losses equal {u1[1] == u2[1]} | window L1 loss "
        f"{u1[1][0][1]:.6f}, f32's {f32_losses[0]:.6f} (max|d| {err:.4g} m, tol "
        f"{0.15 * scale:.4g} m) | mini-step {u1[2]:.1f} / {u2[2]:.1f} ms (median of "
        f"{u1[3]}, CUDA events) | launches per mini-step "
        f"{({k: v / u1[3] for k, v in u1[4].items() if v})}")
    if unequal or u1[1] != u2[1]:
        raise AssertionError(f"the bf16 unsorted rerun differs: {len(unequal)} tensors "
                             f"{unequal[:4]}, window losses {u1[1]} vs {u2[1]}")
    if err > 0.15 * scale or not np.isfinite(u1[1][0][1]):
        raise AssertionError(f"bf16 unsorted and f32 window losses differ by {err} m")
    del umodel, u1, u2
    for k, v in sorted_bf16(sorted_serve_out, sorted_train_out, seed).items():
        total[k] = total.get(k, 0) + v
    return _nonzero(total)


# the "cli" phase's city on disk: CITY's scene of the other phases (build_city's
# 90 buildings) written as scripts/make_synthetic_city.py writes its files,
# two 1024 m chunks (train; val, vis and test)
CLI_CHUNKS = ([0.0, 1024.0, 2048.0], [0.0, 1024.0])  # x, and y above the scene's Y0
# kernels the cli phase must launch: training (forward, backward) and serving
CLI_TRAIN_KERNELS = ("pool2", "pool2_bwd", "pool_gather", "scatter_plane2",
                     "scatter_plane2_bwd", "fused_level", "fused_level_scatter",
                     "fused_level_bwd", "level_d_plane", "level_bwd_reduce", "conv_pair",
                     "conv_decoder")
CLI_TEST_KERNELS = ("pool2", "scatter_plane2", "fused_level", "fused_level_scatter",
                    "conv_pair", "conv_decoder")
STAT_TOL = 1e-5  # the evaluator's float32 sums against float64, relative (+ 1e-5 m)


def _cli_overrides(root: str) -> list:
    """``dataset=synthetic`` on the city under ``root`` with the headline
    network (``headline_config()``'s model subtree: ALTO depth 6, the image
    U-Net, the footprint head, fused2 and the conv kernel flags), the base
    config's point buckets, batch 8, ``optimize_every`` 4, 2 iterations,
    validation, a checkpoint and the vis split's nDSM at the second (every
    iteration until PR 15: two of its four 1.1 GB checkpoint writes go)."""
    from tomosar2height_tpu_torch.config import CONV_KERNELS, KERNEL_PATH
    from tomosar2height_tpu_torch.data.synthetic import Y0

    xs, ys = CLI_CHUNKS
    return ["dataset=synthetic", f"gt_dsm={root}/raster/ndsm.tif",
            f"mask_files.building={root}/raster/footprint.tif",
            f"input_pointcloud_folder={root}/cloud", f"output.output_folder={root}/generated",
            f"dataset.path={root}/generated", f"dataset.satellite_image.folder={root}/raster",
            f"dataset.mask_files.building={root}/raster/footprint.tif",
            f"dataset.mask_files.type={root}/raster/building_class.tif",
            f"training.out_dir={root}/outputs", f"chunk.chunk_x={xs}",
            f"chunk.chunk_y={[Y0 + y for y in ys]}", "use_image=true",
            "model.encoder_kwargs.unet_kwargs.depth=6",
            "dataset.points.bucket_sizes=[2048,4096,8192,16384,32768,65536]",
            "dataset.points.train_bucket=16384", "training.batch_size=8",
            "training.optimize_every=4", "training.val_batch_size=8",
            "training.max_iteration=2", "training.validate_every=2",
            "training.checkpoint_every=2", "training.visualize_every=2"
            ] + KERNEL_PATH + CONV_KERNELS


def _f64_stats(dsm, gt, masks) -> dict:
    """The evaluator's statistics recomputed in float64 from the two rasters
    (scene window of the GT, NaN dropped), per mask."""
    r = dsm.astype(np.float64) - gt.astype(np.float64)
    out = {}
    for key, m in {"overall": np.ones(r.shape, bool), **masks}.items():
        v = r[m]
        v = v[~np.isnan(v)]
        med = np.median(v)
        out[key] = {"max": v.max(), "min": v.min(), "MAE": np.abs(v).mean(),
                    "RMSE": np.sqrt((v ** 2).mean()), "abs_median": np.median(np.abs(v)),
                    "median": med, "n_pixel": v.size,
                    "NMAD": 1.4826 * np.median(np.abs(v - med))}
    return out


def cli_phase(smi: str, seed: int = 0):
    """The port's entry points on the synthetic city written to disk:
    ``cli.build_dataset``, ``cli.train`` (the headline network, 2 iterations
    on the kernel path) and ``cli.test`` on the checkpoint it wrote; the
    test raster held bit-equal to an in-process DSMGenerator that loads the
    same checkpoint over the in-memory SceneDataset of the same city, the
    report's statistics to a float64 recomputation from the two rasters,
    ``metrics.jsonl`` read back; then in bf16 (``model.dtype=bfloat16``)
    ``cli.train`` one iteration and ``cli.test`` on the f32 checkpoint, its
    raster within the bf16 gate of the f32 one and every bf16 kernel of the
    path launched. Returns the launches of the phase."""
    import tempfile

    import torch
    from scipy import ndimage

    from tomosar2height_tpu_torch.cli import build_dataset as cli_build
    from tomosar2height_tpu_torch.cli import test as cli_test
    from tomosar2height_tpu_torch.cli import train as cli_train
    from tomosar2height_tpu_torch.config import compose, default_conf_dir, headline_config
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, write_city
    from tomosar2height_tpu_torch.geo import RasterData, RasterReader, crop_pc_2d, load_pc
    from tomosar2height_tpu_torch.infer import print_statistics
    from tomosar2height_tpu_torch.infer.generator import make_generator
    from tomosar2height_tpu_torch.models import build_model
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.train.checkpoint import CheckpointIO

    w, h = CITY["W"], CITY["H"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        city = write_city(root, seed, **CITY, n_buildings=90)
        write_s = time.perf_counter() - t0
        ov = _cli_overrides(root)
        cfg = compose(default_conf_dir(), overrides=ov)
        if cfg["model"].to_dict() != headline_config()["model"].to_dict():
            raise AssertionError("the cli phase's network is not the headline network")
        t0 = time.perf_counter()
        chunks = cli_build.main(ov)
        build_s = time.perf_counter() - t0

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_launches()
        t0 = time.perf_counter()
        out = cli_train.run(ov)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = dict(runtime.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        wins = out["windows"]
        stepped = sum(x["time_loader_s"] + x["time_step_s"] + x["time_log_s"] for x in wins)
        patches_s = sum(x["n_patches"] for x in wins) / stepped
        ckpt_dir = os.path.join(out["run_dir"], "check_points")
        ckpt_mib = os.path.getsize(os.path.join(ckpt_dir, "model_2.ckpt")) / 2**20
        del out

        runtime.reset_launches()
        t0 = time.perf_counter()
        res = cli_test.run(ov)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = dict(runtime.LAUNCHES)
        gstats = res["generator"].last_stats
        dsm = RasterReader(res["dsm_path"]).get_data()

        # the same checkpoint, in process, over the city held in memory
        model = build_model(cfg, DEVICE)
        CheckpointIO(os.path.join(root, "inproc"), model=model).load(
            os.path.join(ckpt_dir, "model_best.ckpt"), resume_scheduler=False)
        info = chunks[cfg["dataset"]["test_chunks"][0]]
        pts, _ = crop_pc_2d(load_pc(city["cloud"]), info["min_bound"][:2],
                            info["max_bound"][:2])
        rgb = RasterReader(city["rgb"])
        image = (np.stack([rgb.get_data(b) for b in (1, 2, 3)]),
                 RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0)))
        gen = make_generator(model, cfg, [{"name": info["name"], "points": pts,
                                           "min_bound": info["min_bound"],
                                           "max_bound": info["max_bound"]}], image=image)
        runtime.reset_launches()
        inproc = gen.generate_dsm(os.path.join(root, "inproc.tif")).data
        inproc_launches = dict(runtime.LAUNCHES)
        bit_equal = dsm.shape == inproc.shape and np.array_equal(dsm, inproc, equal_nan=True)
        del model, gen


        # the report against float64 from the two rasters
        gt_reader = RasterReader(city["ndsm"])
        col, row = gt_reader.query_col_row(*(res["raster"].T * (0.5, 0.5)))
        win = (slice(row, row + dsm.shape[0]), slice(col, col + dsm.shape[1]))
        building = ndimage.binary_dilation(
            RasterReader(city["footprint"]).get_data().astype(bool), iterations=2)[win]
        btype = RasterReader(city["building_class"]).get_data()
        masks = {"terrain": ~building, "building": building, "non_building": btype[win] == 0,
                 "residential": ndimage.binary_dilation(btype == 1, iterations=2)[win],
                 "non_residential": ndimage.binary_dilation(btype == 2, iterations=2)[win],
                 "building_combined": ndimage.binary_dilation(btype > 0, iterations=2)[win]}
        want = _f64_stats(dsm, gt_reader.get_data()[win], masks)
        stats = res["stats"]
        worst = 0.0
        for key, ref in want.items():
            for stat, v in ref.items():
                got = stats[key][stat]
                if stat == "n_pixel":
                    if got != v:
                        raise AssertionError(f"{key} n_pixel {got} != {v}")
                    continue
                err = abs(got - v) / (STAT_TOL * abs(v) + STAT_TOL)
                worst = max(worst, err)
                if err > 1.0:
                    raise AssertionError(f"{key} {stat}: report {got}, float64 {v}")
        with open(res["eval_path"]) as f:
            report = f.read()
        text = print_statistics(stats, f"TomoSAR2Height-synthetic-iter{res['n_iter']}",
                                has_binary=True, has_ternary=True)
        overall = next(line.split() for line in report.splitlines()
                       if line.startswith("Overall"))
        printed = dict(zip(("MAE", "RMSE", "abs_median", "max", "min", "median", "NMAD"),
                           map(float, overall[1:8])))
        report_ok = (report.splitlines()[1:] == text.splitlines()[1:] and all(
            abs(v - want["overall"][k]) <= 5e-5 + STAT_TOL * abs(want["overall"][k])
            for k, v in printed.items()))
        with open(os.path.join(os.path.dirname(ckpt_dir), "wandb", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f][1:]
        jsonl_ok = ([r["_step"] for r in recs] == [1, 2]
                    and all(np.isfinite(r["train/loss"]) for r in recs)
                    and "val/loss" in recs[1] and "nDSM/overall/RMSE" in recs[1]
                    and "nDSM/building/NMAD" in recs[1])

        # bf16 through the entry points: cli.train an iteration from scratch
        # (a run of its own), cli.test on the f32 run's checkpoint (the file
        # holds the same f32 arrays in either dtype), after the f32 run's
        # report and log are read: cli.test writes to the same paths
        ov16 = ov + ["model.dtype=bfloat16"]
        runtime.reset_launches()
        t0 = time.perf_counter()
        out16 = cli_train.run(ov16 + ["run_suffix=-bf16", "training.max_iteration=1",
                                      "training.validate_every=0",
                                      "training.visualize_every=0"])
        res16 = cli_test.run(ov16)
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
        bf16_launches = dict(runtime.LAUNCHES)
        loss16 = out16["windows"][0]["loss"]
        dsm16 = RasterReader(res16["dsm_path"]).get_data()
        nan = np.isnan(dsm)
        scale = max(1.0, float(np.abs(dsm[~nan]).max()))
        d16 = np.abs(dsm16[~nan] - dsm[~nan])
        corr16 = float(np.corrcoef(dsm16[~nan], dsm[~nan])[0, 1])
        bf16_ok = (np.isfinite(loss16) and np.array_equal(np.isnan(dsm16), nan)
                   and d16.max() <= 0.15 * scale and corr16 > 0.99)
        del out16, res16
    ov_ = stats["overall"]
    log("cli", f"{smi} | write_city {write_s:.2f} s ({city['n_points']} points), "
        f"build_dataset {build_s:.3f} s ({len(chunks)} chunks) | cli.train "
        f"{train_s:.1f} s: {patches_s:.2f} train patches/s (2 windows, checkpoints, "
        f"validation and visualization not counted), mini-step "
        f"{out_ms(wins)} ms, peak {peak / 2**30:.2f} GiB, checkpoint {ckpt_mib:.1f} MiB | "
        f"cli.test {test_s:.2f} s: {gstats['patches_per_s']:.2f} tiles/s "
        f"({gstats['n_patches']} tiles, iteration {res['n_iter']}) | report RMSE "
        f"{ov_['RMSE']:.4f} MAE {ov_['MAE']:.4f} NMAD {ov_['NMAD']:.4f} m, building RMSE "
        f"{stats['building']['RMSE']:.4f} m")
    log("cli", f"checks: cli.test raster {dsm.shape} bit-equal to the in-process generator "
        f"on the in-memory city {bit_equal} | report vs float64 recomputation: worst "
        f"{worst:.3g} of its tolerance ({STAT_TOL:g} rel + {STAT_TOL:g} m), eval.txt "
        f"{report_ok} | metrics.jsonl iterations and nDSM entries {jsonl_ok} | launches "
        f"cli.train {_nonzero(train_launches)}, cli.test {_nonzero(test_launches)}, "
        f"in-process {_nonzero(inproc_launches)}")
    log("cli", f"bf16 (model.dtype=bfloat16): cli.train one iteration and cli.test on the f32 "
        f"checkpoint {bf16_s:.1f} s, window loss {loss16:.4f} | test raster vs the f32 "
        f"cli.test raster: max|d| {float(d16.max()):.4g} m (tol {0.15 * scale:.4g} m), "
        f"correlation {corr16:.6f}, NaN masks equal {np.array_equal(np.isnan(dsm16), nan)} "
        f"| launches {_nonzero(bf16_launches)}")
    if not bit_equal:
        raise AssertionError("cli.test and the in-process generator gave different rasters")
    if not report_ok or not jsonl_ok:
        raise AssertionError(f"eval.txt {report_ok}, metrics.jsonl {jsonl_ok}")
    if not bf16_ok:
        raise AssertionError("the bf16 entry points' loss or raster is off")
    missing = ([k for k in CLI_TRAIN_KERNELS if not train_launches.get(k)]
               + [k for k in CLI_TEST_KERNELS if not test_launches.get(k)]
               + [f"{k}_bf16" for k in CLI_TRAIN_KERNELS if not bf16_launches.get(f"{k}_bf16")])
    if missing:
        raise AssertionError(f"the cli phase did not launch {missing}")
    return {k: train_launches.get(k, 0) + test_launches.get(k, 0) + bf16_launches.get(k, 0)
            for k in set(train_launches) | set(test_launches) | set(bf16_launches)}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def out_ms(windows) -> str:
    """The windows' median CUDA-event mini-step milliseconds."""
    return ", ".join(f"{x.get('step_ms_median', float('nan')):.1f}" for x in windows)


def timed(phase: str, fn, *args):
    """``fn(*args)``, its wall seconds logged under ``phase``."""
    t0 = time.perf_counter()
    out = fn(*args)
    log("time", f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    t0 = time.perf_counter()
    smi = card()
    sass = timed("build", build)
    rows = timed("kernels", check_kernels)
    timed("sass", check_sass, sass)
    timed("model", check_model)
    serve_launches = timed("serve", serve)
    fusion_launches = timed("fusion-serve", fusion_serve)
    sorted_out = timed("sorted-serve", sorted_serve)
    sorted_launches = sorted_out["launches"]
    timed("munich-depth6", munich_depth6)
    launches = timed("train", train_phase)
    sorted_train_out = timed("sorted-train", sorted_train)
    sorted_train_launches = sorted_train_out["launches"]
    headline = timed("headline-train", headline_train)
    headline_launches = headline["launches"]
    bf16_launches = timed("bf16", bf16_phase, headline, sorted_out, sorted_train_out)
    del sorted_out, sorted_train_out
    cli_launches = timed("cli", cli_phase, smi)
    log("time", f"all phases {time.perf_counter() - t0:.1f} s")
    import torch

    for row in rows:
        # K1-K5 (K5's d_plane pass too) and the backwards: the flagship
        # training step; K6 and K7: fusion serving and headline training; K8:
        # fusion serving; K9-K13: sorted serving (K14 is on no model path);
        # the fused layout's backwards: its training step; K1-K8 in bf16:
        # the bf16 phase's serving (K8 on the unsorted path under
        # FAST_CONV) and its timed training step
        name = row["name"]
        key = name.replace("fused_level_bwd_rows", "fused_level_bwd")
        row["launches"] = (launches.get(key)
                           or fusion_launches.get(key, 0) + headline_launches.get(key, 0)
                           or sorted_launches.get(key, 0)
                           or sorted_train_launches.get(key, 0)
                           or bf16_launches.get(key, 0))
        row["launches_serve"] = serve_launches.get(name, 0)
        row["launches_sorted_train"] = sorted_train_launches.get(key, 0)
        row["launches_cli"] = cli_launches.get(key, 0)
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
