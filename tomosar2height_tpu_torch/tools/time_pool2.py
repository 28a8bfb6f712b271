"""The run kernel (``csrc/pool2.cu`` ``pool_runs``) and K2 alone
(``pool_gather``) in each of their uses, timed on the card at the flagship's
shapes, from the port in a given checkout.

    python -m tomosar2height_tpu_torch.tools.time_pool2 [--root DIR]
        [--dtype float32|bfloat16] [--dump DIR] [--against DIR] [--only TEXT]
        [--iters N]

``--root`` is the root of a checkout (default: this one); its package is
imported from there, so that two commits can be compared on one card in one
call, in turns (parent, change, change, parent): the functions take the same
arguments in both trees. The batches, shapes and timers are this checkout's
``chip_smoke.py``, the values drawn on the card in ``--dtype``:

- ``pool2``'s forward (K1 + K2 on the run kernel) and backward (the tie gate
  for max), max and mean, each and both at once, and K2 alone
  (``scatter_plane2_bwd``: a random cotangent plane at the forward's
  counts), at B = 8, 16384-point buckets on the 1024-cell aligned layout,
  F = 32, 256^2;
- K10 (``tile_pool``, max and mean) and its backward (``tile_pool_bwd``: max
  splits each run's cotangent among its tied rows; also on integral values,
  whose cells tie, as ``chip_smoke.check_tile_backwards`` draws them) on
  the 256-cell aligned layout (Npad 32768), F = 32;
- K12's backward (``aligned_scatter_mean_plane_bwd``: K2 at the level's
  shift, the counts of K12's forward; bf16 cuts them) at its 10 shapes
  (``TILE_SCATTER_SHAPES`` and 16^2 at F = 1024) on the same layout, by
  shape and all at once.

Prints the card's name and power limit, then for each use: the median ms of
one call between two CUDA events (``cuda_ms``: on an idle card this includes
the Python wrapper's host time), the median device ms of one call replayed
from a CUDA graph (``graph_ms``) on one copy of the inputs (warm in L2 from
the replay before) and on three copies in turn (as ``chip_smoke.py`` times
it; by shape for K12's backward), and the kernel launches a call makes
(``runtime.LAUNCHES``). ``--dump DIR`` saves every use's outputs (first
copies) to ``DIR/pool2.pt``; ``--against DIR`` counts the elements in which
this checkout's differ from the ones saved there (0 where the two kernels
give the same bits). ``--only TEXT`` keeps the uses whose name holds TEXT
(e.g. ``"pool2 forward max"``); ``--iters`` sets the medians' count (50).
Needs one CUDA card.
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
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--dump", help="save every output here")
    ap.add_argument("--against", help="count the elements that differ from the outputs "
                    "--dump saved here")
    ap.add_argument("--only", help="time only the uses whose name holds this text")
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
    from tomosar2height_tpu_torch.ops.cuda import scatter_kernel as sk

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this timing runs only on a GPU")
    if not pk.__file__.startswith(root):
        raise RuntimeError(f"imported {pk.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev, dt = torch.device("cuda"), getattr(torch, args.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    up = lambda x: torch.from_numpy(x).to(dev).contiguous()  # noqa: E731

    def rows(mask, f):
        return (torch.randn(*mask.shape, f, generator=gen, device=dev)
                * mask[..., None]).to(dt).contiguous()

    def copies(*xs):
        """Three copies of the inputs (the first the inputs themselves)."""
        return [xs] + [tuple(x.clone() if torch.is_tensor(x) else x for x in xs)
                       for _ in range(2)]

    uses = {}  # use -> {shape label: [the call on each copy]}

    # pool2 and K2 alone: the 1024-cell aligned layout
    _, _, _, amask, acell, _ = cs.flagship_batch(0)
    mask, cells = up(amask), up(acell)
    vals, g = rows(mask, 32), rows(torch.ones_like(mask), 32)
    for kind in ("max", "mean"):
        out = pk.pool2(vals, cells, mask, 256, kind)
        uses[f"pool2 forward {kind}"] = {"256^2 F=32": [
            lambda a=a, k=kind: pk.pool2(*a, 256, k) for a in copies(vals, cells, mask)]}
        uses[f"pool2 backward {kind}"] = {"256^2 F=32": [
            lambda a=a, k=kind: pk.pool2_bwd(*a, 256, k)
            for a in copies(g, vals, out, cells, mask)]}
    for part in ("forward", "backward"):
        both = [uses[f"pool2 {part} {k}"]["256^2 F=32"] for k in ("max", "mean")]
        uses[f"pool2 {part} max + mean"] = {"256^2 F=32": [
            lambda fs=fs: [fn() for fn in fs] for fs in zip(*both)]}
    g_plane = torch.randn(amask.shape[0], 256, 256, 32, generator=gen, device=dev).to(dt)
    counts = pk.scatter_plane2(vals, cells, mask, 256)[1]
    uses["K2 alone scatter_plane2_bwd"] = {"256^2 F=32": [
        lambda a=a: pk.scatter_plane2_bwd(*a) for a in copies(g_plane, cells, mask, counts)]}

    # K10, its backward and K12's backward: the 256-cell aligned layout
    _, _, _, tmask_np, tcell, toff = cs.flagship_batch(5, tile_cells=256)
    tmask, tcells, toff = up(tmask_np), up(tcell), up(toff)
    tv, tg = rows(tmask, 32), rows(tmask, 32)
    ties = (torch.randint(0, 3, tv.shape, generator=gen, device=dev).float()
            * tmask[..., None]).to(dt).contiguous()
    for kind in ("max", "mean"):
        uses[f"K10 tile_pool {kind}"] = {"256^2 F=32": [
            lambda a=a, k=kind: tpk.tile_pool(*a, k) for a in copies(tv, tcells, toff)]}
    for label, v, kinds in (("", tv, ("max", "mean")), (" integral ties", ties, ("max",))):
        for kind in kinds:
            out = tpk.tile_pool(v, tcells, toff, kind)
            uses[f"K10 backward {kind}{label}"] = {"256^2 F=32": [
                lambda a=a, k=kind: tpk.tile_pool_bwd(*a, k)
                for a in copies(tg, v, out, tcells, toff)]}
    uses["K12 backward"] = {}
    for i, (r, f) in enumerate(cs.TILE_SCATTER_SHAPES + [(16, 1024)]):
        tl = toff[:, :: 4 ** (9 - r.bit_length())].contiguous()
        kc = sk.aligned_scatter_mean_plane(rows(tmask, f), tcells, tl, r, 256,
                                           with_counts=True)[1]
        gp = torch.randn(tmask.shape[0], r, r, f, generator=gen, device=dev).to(dt)
        uses["K12 backward"][f"{i} {r}^2 F={f}"] = [
            lambda a=a, r=r: sk.aligned_scatter_mean_plane_bwd(*a, r, 256)
            for a in copies(gp, tcells, kc)]

    if args.only:
        uses = {use: group for use, group in uses.items() if args.only in use}
    if args.dump or args.against:
        _compare(uses, root, args.dump, args.against)
    for use, group in uses.items():
        runtime.reset_launches()
        for fns in group.values():
            fns[0]()
        torch.cuda.synchronize()
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        every = [lambda k=k, g=group: [fns[k]() for fns in g.values()] for k in range(3)]
        one = lambda g=group: [fns[0]() for fns in g.values()]  # noqa: E731
        line = (f"{use} {args.dtype} {root}: {cs.cuda_ms(one, iters=args.iters):.4f} ms one "
                f"call (events) | device (graph) {cs.graph_ms(one, iters=args.iters):.4f} ms "
                f"on one copy, {cs.graph_ms(every, iters=args.iters):.4f} ms on three in turn")
        if len(group) > 1:
            per = {label: round(cs.graph_ms(fns, iters=args.iters), 4)
                   for label, fns in group.items()}
            line += f" ({len(group)} shapes); by shape, three copies {per}"
        print(f"{line} | medians of {args.iters} | launches {launches}", flush=True)


def _compare(uses, root, dump, against):
    """Save (``dump``) or count against saved outputs (``against``) every
    use's outputs at every shape, first copies."""
    import torch

    outs = {}
    for use, group in uses.items():
        for label, fns in group.items():
            out = fns[0]()
            out = out if isinstance(out, (tuple, list)) else (out,)
            outs[f"{use} {label}"] = tuple(x.cpu() for x in out)
    if dump:
        os.makedirs(dump, exist_ok=True)
        torch.save(outs, os.path.join(dump, "pool2.pt"))
    if against:
        ref = torch.load(os.path.join(against, "pool2.pt"))
        diff = {k: sum(int((a != b).sum()) for a, b in zip(v, ref[k])) for k, v in outs.items()}
        total = sum(diff.values())
        n = sum(x.numel() for v in outs.values() for x in v)
        print(f"outputs {root} against {against}: {total} of {n} elements differ; by use and "
              f"shape {diff}", flush=True)


if __name__ == "__main__":
    main()
