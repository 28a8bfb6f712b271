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
(the row pass through its C entry point ``t2h_fused_level_bwd``, whose
arguments both trees share), and for the 24 reductions (on random rows of
each level's shapes, as ``chip_smoke.check_kernels`` draws them, beside
``torch.matmul`` of the same product), the card's name and power limit. With ``--profile``, also the
device time by kernel name of one pass of the 24 reductions and of the 24
``torch.matmul`` calls (``torch.profiler``) and the device busy share of
each pass. Needs one CUDA card.
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
    fns, bwd, rows_fns, red, mm = {}, {}, {}, {}, {}
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
        rows = [(torch.randn(m, ka, generator=gen).to(dev),
                 torch.randn(m, nb, generator=gen).to(dev), bias)
                for ka, nb, bias in ((f, 2 * f, True), (2 * f, f, True), (fl, f, False))]
        red[key] = lambda rows=rows: [lk.level_bwd_reduce(*x) for x in rows]
        mm[key] = lambda rows=rows: [torch.matmul(x[0].t(), x[1]) for x in rows]
    for name, group in (("K4", fns), ("K5", bwd), ("K5 rows", rows_fns), ("reduce", red),
                        ("torch.matmul", mm)):
        per = {k: round(cs.cuda_ms(fn, iters=args.iters), 4) for k, fn in group.items()}
        total = cs.cuda_ms(lambda g=group: [fn() for fn in g.values()], iters=args.iters)
        print(f"{name} {root}: {total:.4f} ms for the eight levels (median of "
              f"{args.iters}); by level (R/F/Fl) {per}", flush=True)
    if args.profile:
        for name, group in (("reduce", red), ("torch.matmul", mm)):
            _profile(name, lambda g=group: [fn() for fn in g.values()])


def _row_pass(lk, runtime, bargs):
    """K5's row pass alone, through its C entry point, outputs allocated
    once: the entry point takes the same arguments in both trees."""
    import torch

    plane, c_last, w, xy, cells, mask, counts, g_p, g_c, r, reso = bargs
    b, _, _, f = plane.shape
    n, fl = c_last.shape[1], c_last.shape[2]
    m = b * n
    outs = [torch.empty(shape, device=plane.device) for shape in
            ((b, r, r, f), (b, n, fl), (m, f), (m, 2 * f), (m, f), (m, 2 * f))]
    w_out_t, w_c_t, w_in_t = (x.t().contiguous() for x in (w[2], w[4], w[0]))
    ptrs = [t.data_ptr() for t in (plane, xy, cells, mask, counts, g_p, g_c, w[0], w[1],
                                   w_out_t, w_c_t, w_in_t, *outs)]
    lib, stream = runtime.library(), runtime.stream_ptr(plane.device)
    shift = lk.level_shift(r, reso)

    def fn():
        runtime.check(lib.t2h_fused_level_bwd(*ptrs, b, n, r, f, fl, shift, stream),
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
