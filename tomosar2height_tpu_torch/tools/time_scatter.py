"""The run scatter (``csrc/pool2.cu`` ``scatter_runs``) in each of its uses and
K9 (``tile_gather``) timed on the card at the flagship's shapes, from the port
in a given checkout.

    python -m tomosar2height_tpu_torch.tools.time_scatter [--root DIR]
        [--dtype float32|bfloat16] [--parts] [--dump DIR] [--against DIR]

``--root`` is the root of a checkout (default: this one); its package is
imported from there, so that two commits can be compared on one card in one
call, in turns (parent, change, change, parent): the functions take the same
arguments in both trees. The batches, shapes and timers are this checkout's
``chip_smoke.py``, the values drawn on the card in ``--dtype``:

- K9 (``gather_kernel.tile_gather``) at the eight ``TILE_GATHER_SHAPES`` on
  the 256-cell aligned layout (Npad 32768), by level and all at once;
- K3 (``scatter_plane2``) at B = 8, 16384-point buckets on the 1024-cell
  aligned layout, 256^2, F = 32; K4's plane (``scatter_runs_masked`` at each
  level's shift, the values standing in for K4's c_out) at the eight
  ``LEVEL_SHAPES`` on the same layout;
- K12 (``aligned_scatter_mean_plane``, with its counts) at its 10 shapes
  (``TILE_SCATTER_SHAPES`` and 16^2 at F = 1024) on the 256-cell layout; K14
  (``scatter_mean_plane_v3``) at its four; K11 (``scatter_mean_plane``) and
  K13 (``scatter_mean``) at their 9 on the plain sorted layout of the same
  points, ids shifted and per-cell offsets strided to each level as
  ``check_tile_kernels`` gives them.

Prints the card's name and power limit, then for each use its shapes all at
once and each: the median device ms of one call replayed from a CUDA graph
(``graph_ms``) on three copies of the inputs in turn (as ``chip_smoke.py``
times them), and the kernel launches a call makes (``runtime.LAUNCHES``).
``--parts`` also times K12's steps apart at its ten shapes through
``t2h_scatter_runs_parts``, where the checkout has it (the bits of its
``parts``: 1 clear the flags, 2 the mark pass, 4 the run part, 8 the zero
part; each bit alone, and the whole call). ``--dump DIR`` saves every output
(K9's samples; the planes and counts of each scatter use) to
``DIR/scatter.pt``; ``--against DIR`` counts the elements in which this
checkout's differ from the ones saved there (0 where the two kernels give
the same bits). Needs one CUDA card.
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
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--parts", action="store_true", help="time K12's steps apart")
    ap.add_argument("--dump", help="save every output here")
    ap.add_argument("--against", help="count the elements that differ from the outputs "
                    "--dump saved here")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(args.root or here)
    sys.path.insert(0, here)
    import chip_smoke as cs

    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import torch

    from tomosar2height_tpu_torch.ops.cuda import gather_kernel as gk
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
    dev, dt = torch.device("cuda"), getattr(torch, args.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    up = lambda x: torch.from_numpy(x).to(dev).contiguous()  # noqa: E731

    def rows(mask, f):
        return (torch.randn(*mask.shape, f, generator=gen, device=dev)
                * mask[..., None]).to(dt).contiguous()

    def copies(*xs):
        """Three copies of the inputs (the first the inputs themselves)."""
        return [xs] + [tuple(x.clone() for x in xs) for _ in range(2)]

    uses = {}  # use -> {shape label: [the call on each copy]}

    # K3 and K4's plane: the 1024-cell aligned layout
    _, _, apts, amask, acell, _ = cs.flagship_batch(0)
    mask, cells = up(amask), up(acell)
    uses["K3"] = {"256^2 F=32": [lambda a=a: pk.scatter_plane2(*a, 256)
                                 for a in copies(rows(mask, 32), cells, mask)]}
    uses["K4 plane"] = {
        f"{i} {r}^2 F={f}": [lambda a=a, r=r: pk.scatter_runs_masked(*a, r, 18 - 2 * r.bit_length())
                             for a in copies(rows(mask, f), cells, mask)]
        for i, (r, f, _) in enumerate(cs.LEVEL_SHAPES)}

    # K9, K12 and K14: the 256-cell aligned layout
    pts, pmask, tpts, tmask, tcell, toff = cs.flagship_batch(5, tile_cells=256)
    tmask, tcells, toff = up(tmask), up(tcell), up(toff)
    xy = up(tpts[..., :2])
    uses["K9"] = {}
    for i, (r, f) in enumerate(cs.TILE_GATHER_SHAPES):
        tl = toff[:, :: 4 ** (9 - r.bit_length())].contiguous()
        plane = torch.randn(tmask.shape[0], r, r, f, generator=gen, device=dev).to(dt)
        uses["K9"][f"{i} {r}^2 F={f}"] = [lambda a=a: gk.tile_gather(*a)
                                          for a in copies(plane, xy, tl)]
    uses["K12"], k12_args = {}, []
    for i, (r, f) in enumerate(cs.TILE_SCATTER_SHAPES + [(16, 1024)]):
        tl = toff[:, :: 4 ** (9 - r.bit_length())].contiguous()
        sa = copies(rows(tmask, f), tcells, tl)
        k12_args.append((r, f, sa[0]))
        uses["K12"][f"{i} {r}^2 F={f}"] = [
            lambda a=a, r=r: sk.aligned_scatter_mean_plane(*a, r, 256, with_counts=True)
            for a in sa]
    uses["K14"] = {
        f"{i} {r}^2 F={f}": [lambda a=a, r=r: sk.scatter_mean_plane_v3(*a, r, 256)
                             for a in copies(rows(tmask, f), tcells, toff)]
        for i, (r, f) in enumerate([(256, 32), (128, 128), (64, 256), (32, 512)])}

    # K11 and K13: the plain sorted layout of the same points
    _, smask, scells, soffs = (up(x) for x in cs.sorted_layout(pts, pmask))
    uses["K11"], uses["K13"] = {}, {}
    for i, (r, f) in enumerate(cs.TILE_SCATTER_SHAPES):
        shift = 2 * (9 - r.bit_length())
        sa = copies(rows(smask, f), (scells >> shift).contiguous(),
                    soffs[:, :: 4 ** (shift // 2)].contiguous())
        for use, fn in (("K11", sk.scatter_mean_plane), ("K13", sk.scatter_mean)):
            uses[use][f"{i} {r}^2 F={f}"] = [lambda a=a, fn=fn, r=r: fn(*a, r) for a in sa]

    if args.dump or args.against:
        _compare(uses, root, args.dump, args.against)
    for use, group in uses.items():
        runtime.reset_launches()
        for fns in group.values():
            fns[0]()
        torch.cuda.synchronize()
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        every = [lambda k=k, g=group: [fns[k]() for fns in g.values()] for k in range(3)]
        total = cs.graph_ms(every, iters=args.iters)
        per = {label: round(cs.graph_ms(fns, iters=args.iters), 4)
               for label, fns in group.items()}
        print(f"{use} {args.dtype} {root}: {total:.4f} ms for its {len(group)} shapes, three "
              f"copies in turn (graph replays, median of {args.iters}); by shape {per} | "
              f"launches a pass {launches}", flush=True)
    if args.parts:
        _time_parts(cs, runtime, k12_args, dt, root, args.iters)


def _compare(uses, root, dump, against):
    """Save (``dump``) or count against saved outputs (``against``) every
    use's outputs at every shape, first copies."""
    import torch

    outs = {}
    for use, group in uses.items():
        for label, fns in group.items():
            out = fns[0]()
            out = out if isinstance(out, tuple) else (out,)
            outs[f"{use} {label}"] = tuple(x.cpu() for x in out)
    if dump:
        os.makedirs(dump, exist_ok=True)
        torch.save(outs, os.path.join(dump, "scatter.pt"))
    if against:
        ref = torch.load(os.path.join(against, "scatter.pt"))
        diff = {k: sum(int((a != b).sum()) for a, b in zip(v, ref[k])) for k, v in outs.items()}
        total = sum(diff.values())
        n = sum(x.numel() for v in outs.values() for x in v)
        print(f"outputs {root} against {against}: {total} of {n} elements differ; by use and "
              f"shape {diff}", flush=True)


def _time_parts(cs, runtime, k12_args, dt, root, iters):
    """K12's steps apart at its ten shapes through ``t2h_scatter_runs_parts``
    (one copy of the inputs, outputs allocated once; the zero part alone
    after a whole call has left the flags set)."""
    import torch

    lib = runtime.library()
    name = "t2h_scatter_runs_parts" + ("_bf16" if dt == torch.bfloat16 else "")
    if not hasattr(lib, name):
        print(f"parts {root}: the checkout has no {name}", flush=True)
        return
    fn = getattr(lib, name)
    dev = torch.device("cuda")
    names = {1: "clear", 2: "mark", 4: "runs", 8: "zeros", 12: "runs+zeros", 15: "all"}
    totals = {p: 0.0 for p in names}
    by_shape = []
    for r, f, (v, cells, tl) in k12_args:
        b, n, _ = v.shape
        plane = torch.empty(b, r, r, f, device=v.device, dtype=dt)
        counts = torch.empty(b, r, r, device=v.device, dtype=torch.int32)
        flags = torch.empty(b, r, r, device=v.device, dtype=torch.uint8)

        def call(parts, a=(v.data_ptr(), cells.data_ptr(), 0, tl.data_ptr(), plane.data_ptr(),
                           counts.data_ptr(), flags.data_ptr(), b, n, f, r,
                           2 * (9 - r.bit_length()), tl.shape[1], 1, 0)):
            runtime.check(fn(*a, parts, runtime.stream_ptr(dev)), name)

        call(15)
        ms = {p: cs.graph_ms(lambda p=p: call(p), iters=iters) for p in names}
        for p, t in ms.items():
            totals[p] += t
        by_shape.append(f"{r}^2 F={f} " + " ".join(f"{names[p]} {t:.4f}" for p, t in ms.items()))
    print(f"parts {dt} {root} (graph replays, median of {iters}; ms): all 10 shapes "
          + " ".join(f"{names[p]} {t:.4f}" for p, t in totals.items()) + " | by shape: "
          + "; ".join(by_shape), flush=True)


if __name__ == "__main__":
    main()
