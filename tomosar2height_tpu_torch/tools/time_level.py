"""K4 (``fused_level``) at the eight level round trips of a flagship forward,
timed on the card, from the port in a given checkout.

    python -m tomosar2height_tpu_torch.tools.time_level [--root DIR]

``--root`` is the root of a checkout (default: this one); its package and its
``chip_smoke.py`` (the flagship batch, ``LEVEL_SHAPES``, the weight draw and
the CUDA-event timer) are imported from there, so that two commits can be
compared on one card in one call, in turns (parent, change, change,
parent). Prints the median ms of all eight levels and of each, the card's
name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import torch

    import chip_smoke as cs
    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk

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
    fns = {}
    for r, f, fl in cs.LEVEL_SHAPES:
        plane = torch.randn(b, r, r, f, generator=gen).to(dev)
        c_last = (torch.randn(b, npad, fl, generator=gen).to(dev) * mask[..., None]).contiguous()
        w = (cs._xavier(gen, f, 2 * f, dev), torch.zeros(2 * f, device=dev),
             cs._xavier(gen, 2 * f, f, dev), torch.zeros(f, device=dev),
             cs._xavier(gen, fl, f, dev), torch.zeros(f, device=dev))
        fns[f"{r}/{f}/{fl}"] = lambda a=(plane, c_last, w, xy, cells, mask, r, 256): \
            lk.fused_level(*a)
    per = {k: round(cs.cuda_ms(fn, iters=args.iters), 4) for k, fn in fns.items()}
    total = cs.cuda_ms(lambda: [fn() for fn in fns.values()], iters=args.iters)
    print(f"K4 {root}: {total:.4f} ms for the eight levels (median of {args.iters}); "
          f"by level (R/F/Fl) {per}", flush=True)


if __name__ == "__main__":
    main()
