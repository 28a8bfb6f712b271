"""``pool2``'s forward and backward (max and mean pooling), K2 alone
(``scatter_plane2_bwd``) and K10 (``tile_pool``, max and mean), timed on the
card at the flagship shapes (B = 8, 16384-point buckets on the aligned
layout, F = 32, 256^2 cells; K10 on 256-cell tiles, Npad 32768), from the
port in a given checkout.

    python -m tomosar2height_tpu_torch.tools.time_pool2 [--root DIR]

``--root`` is the root of a checkout (default: this one); its package is
imported from there, so that two commits can be compared on one card in one
call, in turns (parent, change, change, parent): ``pool2``, ``pool2_bwd``,
``scatter_plane2_bwd`` and ``tile_pool`` take the same arguments in both
trees. The flagship
batches and the timers are this checkout's ``chip_smoke.py``. Prints the
card's name and power limit, then for each (forward, backward) x (max, mean)
call, for the forward and the backward over both kinds, for K2 alone (the
plane cotangent at the cells of the forward's counts) and for K10's two
kinds (as ``chip_smoke.py`` times it): the median ms of one call between
two CUDA events (``cuda_ms``: on an idle card this includes the Python
wrapper's host time), the median device ms of one call replayed from a CUDA
graph (``graph_ms``) on one copy of the inputs (warm in L2 from the replay
before) and on three copies in turn (as ``chip_smoke.py`` times it); and
the kernel launches each call makes (``runtime.LAUNCHES``). Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(args.root or here)
    sys.path.insert(0, here)
    import chip_smoke as cs

    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import torch

    from tomosar2height_tpu_torch.ops.cuda import pool2_kernel as pk
    from tomosar2height_tpu_torch.ops.cuda import pool_kernel as tpk
    from tomosar2height_tpu_torch.ops.cuda import runtime

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this timing runs only on a GPU")
    if not pk.__file__.startswith(root):
        raise RuntimeError(f"imported {pk.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    _, _, _, amask, acell, _ = cs.flagship_batch(0)
    gen = torch.Generator().manual_seed(0)
    mask = torch.from_numpy(amask).to(dev)
    cells = torch.from_numpy(acell).to(dev)
    b, npad = amask.shape
    vals = (torch.randn(b, npad, 32, generator=gen).to(dev) * mask[..., None]).contiguous()
    g = torch.randn(vals.shape, generator=gen).to(dev)
    sets = [(vals, cells, mask, g)] + [tuple(t.clone() for t in (vals, cells, mask, g))
                                       for _ in range(2)]
    calls = {}
    for kind in ("max", "mean"):
        outs = [pk.pool2(v, c, m, 256, kind) for v, c, m, _ in sets]
        calls[f"pool2 forward {kind}"] = [lambda k=kind, s=s: pk.pool2(*s[:3], 256, k)
                                          for s in sets]
        calls[f"pool2 backward {kind}"] = [
            lambda k=kind, o=o, s=s: pk.pool2_bwd(s[3], s[0], o, s[1], s[2], 256, k)
            for s, o in zip(sets, outs)]
    for part in ("forward", "backward"):
        both = [fns for name, fns in calls.items() if name.startswith(f"pool2 {part}")]
        calls[f"pool2 {part} max + mean"] = [lambda fs=fs: [fn() for fn in fs]
                                             for fs in zip(*both)]
    g_plane = torch.randn(b, 256, 256, 32, generator=gen).to(dev)
    counts = pk.scatter_plane2(vals, cells, mask, 256)[1]
    gsets = [(g_plane, cells, mask, counts)] + [
        tuple(t.clone() for t in (g_plane, cells, mask, counts)) for _ in range(2)]
    calls["K2 alone scatter_plane2_bwd"] = [lambda s=s: pk.scatter_plane2_bwd(*s)
                                            for s in gsets]
    _, _, _, amask, acell, toff = cs.flagship_batch(5, tile_cells=256)
    tmask, tcells, toff = (torch.from_numpy(x).to(dev) for x in (amask, acell, toff))
    tv = (torch.randn(*amask.shape, 32, generator=gen).to(dev) * tmask[..., None]).contiguous()
    tsets = [(tv, tcells, toff)] + [tuple(t.clone() for t in (tv, tcells, toff))
                                    for _ in range(2)]
    for kind in ("max", "mean"):
        calls[f"K10 tile_pool {kind}"] = [lambda k=kind, s=s: tpk.tile_pool(*s, k)
                                          for s in tsets]
    for name, fns in calls.items():
        runtime.reset_launches()
        fns[0]()
        torch.cuda.synchronize()
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        print(f"{name} {root}: {cs.cuda_ms(fns[0], iters=args.iters):.4f} ms one call "
              f"(events) | device (graph) {cs.graph_ms(fns[0], iters=args.iters):.4f} ms on "
              f"one copy, {cs.graph_ms(fns, iters=args.iters):.4f} ms on three in turn | "
              f"medians of {args.iters} | launches {launches}", flush=True)


if __name__ == "__main__":
    main()
