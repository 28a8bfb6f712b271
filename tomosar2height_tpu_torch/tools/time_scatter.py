"""K3 (``scatter_plane2``), K11 (``scatter_mean_plane``), K12
(``aligned_scatter_mean_plane``) and K13 (``scatter_mean``) timed on the card
at the flagship's shapes, from the port in a given checkout.

    python -m tomosar2height_tpu_torch.tools.time_scatter [--root DIR]

``--root`` is the root of a checkout (default: this one); its package is
imported from there, so that two commits can be compared on one card in one
call, in turns (parent, change, change, parent): the functions take the same
arguments in both trees. The batches, shapes and timers are this checkout's
``chip_smoke.py``: K3 at B = 8, 16384-point buckets on the 1024-cell aligned
layout, 256^2, F = 32; K12 at each of its 10 shapes (``TILE_SCATTER_SHAPES``
and 16^2 at F = 1024) on the 256-cell layout (Npad 32768); K11 at each of
its 9 (``TILE_SCATTER_SHAPES``) on the plain sorted layout of the same
points, ids shifted and per-cell offsets strided to each level as
``check_tile_kernels`` gives them, and K13 on K11's inputs. Prints the
card's name and power limit, then for K3, for each K12, K11 and K13 shape
and for each one's shapes together: the median device ms of one call replayed from a CUDA graph
(``graph_ms``) on three copies of the inputs in turn (as ``chip_smoke.py``
times it) and on one copy (warm in L2 from the replay before), and the kernel
launches each call makes (``runtime.LAUNCHES``). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--iters", type=int, default=20)
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
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this timing runs only on a GPU")
    if not pk.__file__.startswith(root):
        raise RuntimeError(f"imported {pk.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rows(mask, f):
        return (torch.randn(*mask.shape, f, generator=gen).to(dev) * mask[..., None]).contiguous()

    calls = {}
    _, _, _, amask, acell, _ = cs.flagship_batch(0)
    mask, cells = (torch.from_numpy(x).to(dev) for x in (amask, acell))
    v = rows(mask, 32)
    sets = [(v, cells, mask)] + [tuple(t.clone() for t in (v, cells, mask)) for _ in range(2)]
    calls["K3 scatter_plane2 256^2 F=32"] = [
        lambda s=s: pk.scatter_plane2(*s, 256) for s in sets]

    pts, pmask, _, amask, acell, toff = cs.flagship_batch(5, tile_cells=256)
    mask, cells, toff = (torch.from_numpy(x).to(dev) for x in (amask, acell, toff))
    copies = [(cells, toff)] + [(cells.clone(), toff.clone()) for _ in range(2)]
    every = [[], [], []]
    for i, (r, f) in enumerate(cs.TILE_SCATTER_SHAPES + [(16, 1024)]):
        v = rows(mask, f)
        fns = []
        for k, (c, t) in enumerate(copies):
            a = (v if k == 0 else v.clone(), c, t[:, :: 4 ** (9 - r.bit_length())].contiguous(),
                 r, 256)
            fns.append(lambda a=a: sk.aligned_scatter_mean_plane(*a))
            every[k].append(fns[-1])
        calls[f"K12 shape {i} {r}^2 F={f}"] = fns
    calls["K12 all 10 shapes"] = [lambda fs=fs: [fn() for fn in fs] for fs in every]

    _, smask, scells, soffs = (torch.from_numpy(x).to(dev) for x in cs.sorted_layout(pts, pmask))
    copies = [(scells, soffs)] + [(scells.clone(), soffs.clone()) for _ in range(2)]
    sorted_args = []
    for r, f in cs.TILE_SCATTER_SHAPES:
        shift = 2 * (9 - r.bit_length())
        v = rows(smask, f)
        sorted_args.append([(v if k == 0 else v.clone(), (c >> shift).contiguous(),
                             o[:, :: 4 ** (shift // 2)].contiguous(), r)
                            for k, (c, o) in enumerate(copies)])
    for label, fn in (("K11", sk.scatter_mean_plane), ("K13", sk.scatter_mean)):
        every = [[], [], []]
        for i, ((r, f), sa) in enumerate(zip(cs.TILE_SCATTER_SHAPES, sorted_args)):
            fns = [lambda a=a, fn=fn: fn(*a) for a in sa]
            for k in range(3):
                every[k].append(fns[k])
            calls[f"{label} shape {i} {r}^2 F={f}"] = fns
        calls[f"{label} all 9 shapes"] = [lambda fs=fs: [fn() for fn in fs] for fs in every]
    for name, fns in calls.items():
        runtime.reset_launches()
        fns[0]()
        torch.cuda.synchronize()
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        print(f"{name} {root}: device (graph) {cs.graph_ms(fns, iters=args.iters):.4f} ms on "
              f"three copies in turn, {cs.graph_ms(fns[0], iters=args.iters):.4f} ms on one | "
              f"medians of {args.iters} | launches {launches}", flush=True)


if __name__ == "__main__":
    main()
