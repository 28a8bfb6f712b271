"""The conv kernels at the shapes of a batch-8 fusion forward, timed on the
card, from the port in a given checkout, beside their plain versions:

- ``--kernel pair`` (default): K7 (``conv_pair``) at the 20 conv-pair shapes
  (``chip_smoke.ALTO_PAIRS + IMAGE_PAIRS``); plain: two cuDNN convs in full
  float32, the pool as ``F.max_pool2d``;
- ``--kernel conv3x3``: K8 (``conv3x3``, with ReLU) at the 43 convs
  (``chip_smoke.CONVS``); plain: one cuDNN conv in full float32;
- ``--kernel decoder``: K6 (``conv_decoder``) at the decoder
  (``chip_smoke.DECODER``); plain: three cuDNN convs and the head.

    python -m tomosar2height_tpu_torch.tools.time_conv_pair [--root DIR] [--kernel K]

``--root`` is the root of a checkout (default: this one); its package and
its ``chip_smoke.py`` (the shapes, the weight draw and the CUDA-event timer)
are imported from there, so that two commits can be compared on one card in
one call, in turns (parent, change, change, parent). Prints the card's name
and power limit, the median ms of all shapes in one go, and of each shape,
kernel / plain. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _cases(kernel, cs, gen, dev):
    """(name, kernel fn, plain fn) for each shape of ``kernel``."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
    from tomosar2height_tpu_torch.ops.cuda import convpair_kernel as cpk
    from tomosar2height_tpu_torch.ops.cuda import decoder_kernel as dk

    x_of = lambda h, c: torch.randn(8, h, h, c, generator=gen).to(dev)  # noqa: E731
    if kernel == "pair":
        for h, cin, c, pool in cs.ALTO_PAIRS + cs.IMAGE_PAIRS:
            a = (x_of(h, cin), *cs._conv_w(gen, cin, c, 3, dev), *cs._conv_w(gen, c, c, 3, dev))
            yield (f"{h}^2 {cin}->{c}{' pool' if pool else ''}",
                   lambda a=a, p=pool: cpk.conv_pair(*a, p),
                   lambda a=a, p=pool: cpk.conv_pair_plain(*a, p))
    elif kernel == "conv3x3":
        for h, cin, cout in cs.CONVS:
            a = (x_of(h, cin), *cs._conv_w(gen, cin, cout, 3, dev))
            yield (f"{h}^2 {cin}->{cout}", lambda a=a: ck.conv3x3(*a, True),
                   lambda a=a: ck.conv3x3_plain(*a, True))
    else:
        h, c0, (c1, c2, c3), co = cs.DECODER
        a = (x_of(h, c0), *cs._conv_w(gen, c0, c1, 3, dev), *cs._conv_w(gen, c1, c2, 3, dev),
             *cs._conv_w(gen, c2, c3, 3, dev), *cs._conv_w(gen, c0 + c1 + c2 + c3, co, 1, dev))
        yield (f"{h}^2 {c0}->{c1}->{c2}->{c3} head {co}", lambda: dk.conv_decoder(*a),
               lambda: dk.conv_decoder_plain(*a))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--kernel", choices=("pair", "conv3x3", "decoder"), default="pair")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import torch

    import chip_smoke as cs
    from tomosar2height_tpu_torch.ops.cuda import runtime

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this timing runs only on a GPU")
    if not runtime.__file__.startswith(root):
        raise RuntimeError(f"imported {runtime.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    names, kfns, pfns = zip(*_cases(args.kernel, cs, torch.Generator().manual_seed(7), dev))
    total = cs.cuda_ms(lambda: [fn() for fn in kfns], iters=args.iters)
    plain = cs.cuda_ms(lambda: [fn() for fn in pfns], iters=args.iters)
    per = "; ".join(f"{n} {cs.cuda_ms(k, args.iters, 1):.3f}/{cs.cuda_ms(p, args.iters, 1):.3f}"
                    for n, k, p in zip(names, kfns, pfns))
    print(f"{args.kernel} {root}: {total:.4f} ms for the {len(names)} shapes, plain "
          f"{plain:.4f} ms (median of {args.iters}); by shape, kernel/plain ms: {per}",
          flush=True)


if __name__ == "__main__":
    main()
