"""K4 (``fused_level``), K5 (``fused_level_bwd``), K5's row pass alone and
its weight-gradient reductions (``level_bwd_reduce``, three a level) at the
eight level round trips of a flagship forward, timed on the card, from the
port in a given checkout.

    python -m tomosar2height_tpu_torch.tools.time_level [--root DIR]

``--root`` is the root of a checkout (default: this one); its package and its
``chip_smoke.py`` (the flagship batch, ``LEVEL_SHAPES``, the weight draw and
the CUDA-event timer) are imported from there, so that two commits can be
compared on one card in one call, in turns (parent, change, change,
parent). Prints the median ms of all eight levels and of each, for K4, for
K5 and its row pass on random output cotangents with the forward's counts
(the row pass through its C entry point ``t2h_fused_level_bwd``: a tree
with ``level_kernel.level_d_plane`` writes d_s there where an older one
writes d_plane, and runs the d_plane pass apart, which is then timed on its
own), and for the 24 reductions (on random rows of
each level's shapes, as ``chip_smoke.check_kernels`` draws them, beside
``torch.matmul`` of the same product), the card's name and power limit. With ``--profile``, also the
device time by kernel name of one pass of the 24 reductions and of the 24
``torch.matmul`` calls (``torch.profiler``) and the device busy share of
each pass. With ``--dtype bfloat16``: K4 in bf16 (``fused_level`` on bf16
plane, c_last and weights, drawn on the card as ``chip_smoke._level_rows``
draws them: its kernel and its run scatter) for the eight levels at once and
for each, then the 24 reductions on bf16 rows (``csrc/reduce_bf16.cu`` where
the checkout has it) beside ``torch.matmul`` in bf16, all at once and each
by (Ka, Nb), K5's bf16 row pass through its C entry point
``t2h_fused_level_bwd_bf16`` (on random output cotangents with the
forward's counts, outputs allocated once) for the eight levels at once and
for each, and K5's d_plane pass in its five uses (bf16, f32, and f32 into a
bf16 plane on K5's layout; K9's backward in f32 and bf16 on the ``fused``
layout, 256-cell tiles) for the eight levels at once and for each, all
timed by CUDA graph replays (``chip_smoke.graph_ms``, as the smoke's kernel
rows). ``--dump DIR`` saves the d_plane outputs of every use and level to
``DIR/d_plane.pt``; ``--against DIR`` counts the elements in which this
checkout's differ from the ones saved there (0 where the two kernels give
the same bits). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--dump", help="with --dtype bfloat16: save the d_plane outputs here")
    ap.add_argument("--against", help="with --dtype bfloat16: count the d_plane elements "
                    "that differ from the outputs --dump saved here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import torch

    import chip_smoke as cs
    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
    from tomosar2height_tpu_torch.ops.cuda import runtime

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this timing runs only on a GPU")
    if not lk.__file__.startswith(root):
        raise RuntimeError(f"imported {lk.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    _, _, apts, amask, acell, _ = cs.flagship_batch(0)
    gen = torch.Generator().manual_seed(0)
    xy = torch.from_numpy(apts[..., :2]).to(dev).contiguous()
    mask = torch.from_numpy(amask).to(dev)
    cells = torch.from_numpy(acell).to(dev)
    b, npad = amask.shape
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dtype == "bfloat16":
        _time_bf16_level(cs, lk, xy, cells, mask, root, args.iters)
        _time_bf16_reduce(cs, lk, gen, dev, b * npad, root, args.iters)
        _time_bf16_rows(cs, lk, runtime, xy, cells, mask, root, args.iters)
        _time_d_plane(cs, lk, xy, cells, mask, root, args.iters, args.dump, args.against)
        return
    fns, bwd, rows_fns, red, mm, dplane = {}, {}, {}, {}, {}, {}
    m = b * npad
    for r, f, fl in cs.LEVEL_SHAPES:
        plane = torch.randn(b, r, r, f, generator=gen).to(dev)
        c_last = (torch.randn(b, npad, fl, generator=gen).to(dev) * mask[..., None]).contiguous()
        w = (cs._xavier(gen, f, 2 * f, dev), torch.zeros(2 * f, device=dev),
             cs._xavier(gen, 2 * f, f, dev), torch.zeros(f, device=dev),
             cs._xavier(gen, fl, f, dev), torch.zeros(f, device=dev))
        key = f"{r}/{f}/{fl}"
        fns[key] = lambda a=(plane, c_last, w, xy, cells, mask, r, 256): lk.fused_level(*a)
        counts = lk.fused_level(plane, c_last, w, xy, cells, mask, r, 256)[2]
        g_p = torch.randn(b, r, r, f, generator=gen).to(dev)
        g_c = torch.randn(b, npad, f, generator=gen).to(dev)
        bargs = (plane, c_last, w, xy, cells, mask, counts, g_p, g_c, r, 256)
        bwd[key] = lambda a=bargs: lk.fused_level_bwd(*a)
        rows_fns[key] = _row_pass(lk, runtime, bargs)
        if hasattr(lk, "level_d_plane"):
            d_s = torch.randn(b, npad, f, generator=gen).to(dev)
            dplane[key] = lambda a=(d_s, xy, cells, mask, r, 256): lk.level_d_plane(*a)
        rows = [(torch.randn(m, ka, generator=gen).to(dev),
                 torch.randn(m, nb, generator=gen).to(dev), bias)
                for ka, nb, bias in ((f, 2 * f, True), (2 * f, f, True), (fl, f, False))]
        red[key] = lambda rows=rows: [lk.level_bwd_reduce(*x) for x in rows]
        mm[key] = lambda rows=rows: [torch.matmul(x[0].t(), x[1]) for x in rows]
    groups = [("K4", fns), ("K5", bwd), ("K5 rows", rows_fns), ("reduce", red),
              ("torch.matmul", mm)]
    if dplane:
        groups.append(("K5 d_plane", dplane))
    for name, group in groups:
        per = {k: round(cs.cuda_ms(fn, iters=args.iters), 4) for k, fn in group.items()}
        total = cs.cuda_ms(lambda g=group: [fn() for fn in g.values()], iters=args.iters)
        print(f"{name} {root}: {total:.4f} ms for the eight levels (median of "
              f"{args.iters}); by level (R/F/Fl) {per}", flush=True)
    if args.profile:
        for name, group in (("reduce", red), ("torch.matmul", mm)):
            _profile(name, lambda g=group: [fn() for fn in g.values()])


def _time_bf16_level(cs, lk, xy, cells, mask, root, iters):
    """K4 in bf16 at the eight flagship levels (``chip_smoke.LEVEL_SHAPES``)
    on inputs drawn on the card as ``chip_smoke._level_rows`` draws them
    (the plane, c_last on the valid rows, Xavier weights, zero biases, all
    rounded to bf16): all at once and each by (R/F/Fl), graph replays."""
    import torch

    dev, bf = mask.device, torch.bfloat16
    b, npad = mask.shape
    cgen = torch.Generator(device=dev).manual_seed(0)
    fns = {}
    for r, f, fl in cs.LEVEL_SHAPES:
        plane = torch.randn(b, r, r, f, generator=cgen, device=dev).to(bf)
        c_last = (torch.randn(b, npad, fl, generator=cgen, device=dev)
                  * mask[..., None]).to(bf)
        w = tuple(x.to(bf) for x in (
            cs._xavier(cgen, f, 2 * f, dev), torch.zeros(2 * f, device=dev),
            cs._xavier(cgen, 2 * f, f, dev), torch.zeros(f, device=dev),
            cs._xavier(cgen, fl, f, dev), torch.zeros(f, device=dev)))
        fns[f"{r}/{f}/{fl}"] = lambda a=(plane, c_last, w, xy, cells, mask, r, 256): \
            lk.fused_level(*a)
    total = cs.graph_ms(lambda: [fn() for fn in fns.values()], iters)
    per = {k: round(cs.graph_ms(fn, iters), 4) for k, fn in fns.items()}
    print(f"K4 bf16 {root}: {total:.4f} ms for the eight levels (graph replays, median of "
          f"{iters}); by level (R/F/Fl) {per}", flush=True)


def _time_bf16_reduce(cs, lk, gen, dev, m, root, iters):
    """The 24 weight sums of the eight levels on bf16 rows (as
    ``chip_smoke.check_kernels`` draws them, on the card) beside
    ``torch.matmul`` in bf16: all at once, and each by (Ka, Nb), by CUDA
    graph replays (device time)."""
    import torch

    bf = torch.bfloat16
    cgen = torch.Generator(device=dev).manual_seed(0)
    red, mm = {}, {}
    for _, f, fl in cs.LEVEL_SHAPES:
        for ka, nb, bias in ((f, 2 * f, True), (2 * f, f, True), (fl, f, False)):
            rows = (torch.randn(m, ka, generator=cgen, device=dev).to(bf),
                    torch.randn(m, nb, generator=cgen, device=dev).to(bf), bias)
            key = f"{ka}x{nb}{'+b' if bias else ''}#{len(red)}"
            red[key] = lambda x=rows: lk.level_bwd_reduce(*x)
            mm[key] = lambda x=rows: torch.matmul(x[0].t(), x[1])
    for name, group in (("reduce bf16", red), ("torch.matmul bf16", mm)):
        total = cs.graph_ms(lambda g=group: [fn() for fn in g.values()], iters)
        per = {k: round(cs.graph_ms(fn, iters), 4) for k, fn in group.items()}
        print(f"{name} {root}: {total:.4f} ms for the 24 sums (graph replays, median of "
              f"{iters}); by (Ka x Nb, +b with the bias) {per}", flush=True)


def _time_bf16_rows(cs, lk, runtime, xy, cells, mask, root, iters):
    """K5's bf16 row pass at the eight flagship levels, through its C entry
    point (outputs allocated once; the transposes the entry takes made
    once), on bf16 inputs drawn on the card as ``chip_smoke._level_rows``
    draws them, random output cotangents and the forward's counts: all at
    once and each by (R/F/Fl), graph replays."""
    import torch

    dev, bf = mask.device, torch.bfloat16
    b, npad = mask.shape
    cgen = torch.Generator(device=dev).manual_seed(1)
    fns = {}
    for r, f, fl in cs.LEVEL_SHAPES:
        plane = torch.randn(b, r, r, f, generator=cgen, device=dev).to(bf)
        c_last = (torch.randn(b, npad, fl, generator=cgen, device=dev)
                  * mask[..., None]).to(bf)
        w = tuple(x.to(bf) for x in (
            cs._xavier(cgen, f, 2 * f, dev), torch.zeros(2 * f, device=dev),
            cs._xavier(cgen, 2 * f, f, dev), torch.zeros(f, device=dev),
            cs._xavier(cgen, fl, f, dev), torch.zeros(f, device=dev)))
        counts = lk.fused_level(plane, c_last, w, xy, cells, mask, r, 256)[2]
        g_p = torch.randn(b, r, r, f, generator=cgen, device=dev).to(bf)
        g_c = torch.randn(b, npad, f, generator=cgen, device=dev).to(bf)
        fns[f"{r}/{f}/{fl}"] = _row_pass(
            lk, runtime, (plane, c_last, w, xy, cells, mask, counts, g_p, g_c, r, 256))
    total = cs.graph_ms(lambda: [fn() for fn in fns.values()], iters)
    per = {k: round(cs.graph_ms(fn, iters), 4) for k, fn in fns.items()}
    print(f"K5 rows bf16 {root}: {total:.4f} ms for the eight levels (graph replays, median "
          f"of {iters}); by level (R/F/Fl) {per}", flush=True)


def _time_d_plane(cs, lk, xy, cells, mask, root, iters, dump, against):
    """K5's d_plane pass in its five uses at the eight levels: on K5's layout
    (the flagship batch) with d_s in bf16, in f32, and in f32 into a bf16
    plane; as K9's backward (``gather_kernel.tile_gather_bwd``) on the
    ``fused`` layout (256-cell tiles, the smoke's tile batch) in f32 and
    bf16. Each use all at once and each level by (R/F), graph replays;
    ``dump`` / ``against`` as the module says."""
    import numpy as np
    import torch

    from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk

    dev, bf = mask.device, torch.bfloat16
    b, npad = mask.shape
    _, _, tpts, tmask, tcell, _ = cs.flagship_batch(5, tile_cells=256)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    txy, tmask, tcells = up(tpts[..., :2]), up(tmask), up(tcell)
    cgen = torch.Generator(device=dev).manual_seed(2)
    uses = {}
    for r, f, fl in cs.LEVEL_SHAPES:
        d_s = torch.randn(b, npad, f, generator=cgen, device=dev) * mask[..., None]
        g = torch.randn(tmask.shape + (f,), generator=cgen, device=dev) * tmask[..., None]
        key = f"{r}/{f}/{fl}"
        for use, fn in (
                ("K5 bf16", lambda a=(d_s.to(bf), xy, cells, mask, r, 256): lk.level_d_plane(*a)),
                ("K5 f32", lambda a=(d_s, xy, cells, mask, r, 256): lk.level_d_plane(*a)),
                ("K5 f32 into bf16", lambda a=(d_s, xy, cells, mask, r, 256):
                 lk.level_d_plane(*a, out_dtype=bf)),
                ("K9 bwd f32", lambda a=(g, txy, tcells, tmask, r, 256): gk.tile_gather_bwd(*a)),
                ("K9 bwd bf16", lambda a=(g.to(bf), txy, tcells, tmask, r, 256):
                 gk.tile_gather_bwd(*a))):
            uses.setdefault(use, {})[key] = fn
    outs = {use: {k: fn().cpu() for k, fn in group.items()} for use, group in uses.items()}
    if dump:
        os.makedirs(dump, exist_ok=True)
        torch.save(outs, os.path.join(dump, "d_plane.pt"))
    if against:
        ref = torch.load(os.path.join(against, "d_plane.pt"))
        diff = {use: {k: int((outs[use][k] != ref[use][k]).sum()) for k in group}
                for use, group in outs.items()}
        total = sum(v for group in diff.values() for v in group.values())
        n = sum(x.numel() for group in outs.values() for x in group.values())
        print(f"d_plane {root} against {against}: {total} of {n} elements differ; by use and "
              f"level {diff}", flush=True)
    for use, group in uses.items():
        total = cs.graph_ms(lambda g=group: [fn() for fn in g.values()], iters)
        per = {k: round(cs.graph_ms(fn, iters), 4) for k, fn in group.items()}
        print(f"d_plane {use} {root}: {total:.4f} ms for the eight levels (graph replays, "
              f"median of {iters}); by level (R/F/Fl of the round trip) {per}", flush=True)


def _row_pass(lk, runtime, bargs):
    """K5's row pass alone, through its C entry point for the plane's dtype,
    outputs allocated once: the entry point takes 18 pointers in every tree,
    d_plane first in a tree without ``level_d_plane``, d_s last in one with
    it (the bf16 entry of a tree with ``csrc/level_bwd_bf16.cu`` does not
    read w_in_t)."""
    import torch

    plane, c_last, w, xy, cells, mask, counts, g_p, g_c, r, reso = bargs
    b, _, _, f = plane.shape
    n, fl = c_last.shape[1], c_last.shape[2]
    m = b * n
    shapes = [(b, n, fl), (m, f), (m, 2 * f), (m, f), (m, 2 * f)]
    shapes = shapes + [(m, f)] if hasattr(lk, "level_d_plane") else [(b, r, r, f)] + shapes
    outs = [torch.empty(shape, device=plane.device, dtype=plane.dtype) for shape in shapes]
    w_out_t, w_c_t, w_in_t = (x.t().contiguous() for x in (w[2], w[4], w[0]))
    ptrs = [t.data_ptr() for t in (plane, xy, cells, mask, counts, g_p, g_c, w[0], w[1],
                                   w_out_t, w_c_t, w_in_t, *outs)]
    lib, dev = runtime.library(), plane.device
    shift = lk.level_shift(r, reso)
    entry = (lib.t2h_fused_level_bwd_bf16 if plane.dtype == torch.bfloat16
             else lib.t2h_fused_level_bwd)

    keep = (w_out_t, w_c_t, w_in_t, outs)

    def fn():  # on the current stream (a graph capture's, under graph_ms)
        assert keep  # the transposes and outputs live as long as fn
        runtime.check(entry(*ptrs, b, n, r, f, fl, shift, runtime.stream_ptr(dev)),
                      "fused_level_bwd")
    return fn


def _profile(name: str, fn) -> None:
    """Device ms by kernel name of one call of ``fn`` (after two warm ones),
    and the busy share of its host wall."""
    import torch

    from tomosar2height_tpu_torch.tools.profile_forward import _busy_ms

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    by_name: dict = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = _busy_ms(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{name} profile: device {sum(by_name.values()):.4f} ms, busy {busy:.4f} of "
          f"{wall:.4f} ms host wall (profiler on); by kernel "
          + "; ".join(f"{ms:.4f} {k[:60]}" for k, ms in top), flush=True)


if __name__ == "__main__":
    main()
