"""K7 (``conv_pair``) at the 20 conv-pair shapes of a batch-8 fusion
forward (``chip_smoke.ALTO_PAIRS + IMAGE_PAIRS``), timed on the card, from
the port in a given checkout, beside its plain version (two cuDNN convs in
full float32, the pool as ``F.max_pool2d``).

    python -m tomosar2height_tpu_torch.tools.time_conv_pair [--root DIR]

``--root`` is the root of a checkout (default: this one); its package and
its ``chip_smoke.py`` (the shapes, the weight draw and the CUDA-event timer)
are imported from there, so that two commits can be compared on one card in
one call, in turns (parent, change, change, parent). Prints the card's name
and power limit, the median ms of the 20 pairs in one go, and of each pair,
kernel / plain. Needs one CUDA card.
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
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import torch

    import chip_smoke as cs
    from tomosar2height_tpu_torch.ops.cuda import convpair_kernel as cpk

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this timing runs only on a GPU")
    if not cpk.__file__.startswith(root):
        raise RuntimeError(f"imported {cpk.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    kfns, pfns, names = [], [], []
    for h, cin, c, pool in cs.ALTO_PAIRS + cs.IMAGE_PAIRS:
        x = torch.randn(8, h, h, cin, generator=gen).to(dev)
        a = (x, *cs._conv_w(gen, cin, c, 3, dev), *cs._conv_w(gen, c, c, 3, dev))
        kfns.append(lambda a=a, p=pool: cpk.conv_pair(*a, p))
        pfns.append(lambda a=a, p=pool: cpk.conv_pair_plain(*a, p))
        names.append(f"{h}^2 {cin}->{c}{' pool' if pool else ''}")
    total = cs.cuda_ms(lambda: [fn() for fn in kfns], iters=args.iters)
    plain = cs.cuda_ms(lambda: [fn() for fn in pfns], iters=args.iters)
    per = "; ".join(f"{n} {cs.cuda_ms(k, args.iters, 1):.3f}/{cs.cuda_ms(p, args.iters, 1):.3f}"
                    for n, k, p in zip(names, kfns, pfns))
    print(f"conv_pair {root}: {total:.4f} ms for the 20 pairs, plain {plain:.4f} ms (median "
          f"of {args.iters}); by shape, kernel/plain ms: {per}", flush=True)


if __name__ == "__main__":
    main()
