"""The conv kernels at the shapes of a batch-8 fusion forward, timed on the
card, from the port in a given checkout, beside their plain versions:

- ``--kernel pair`` (default): K7 (``conv_pair``) at the 20 conv-pair shapes
  (``chip_smoke.ALTO_PAIRS + IMAGE_PAIRS``); plain: two cuDNN convs in full
  float32, the pool as ``F.max_pool2d``; with ``--dtype bfloat16`` on bf16 x
  (the weights and biases rounded to bf16, as the model passes them), each
  pooled shape also without its pool (the pool's share), and each shape
  beside cuDNN's two bf16 ``F.conv2d`` on ``channels_last`` (no ReLU or
  pool: information, no library call computes a pair), by graph replays;
- ``--kernel conv3x3``: K8 (``conv3x3``, with ReLU) at the 43 convs
  (``chip_smoke.CONVS``); plain: one cuDNN conv in full float32; with
  ``--dtype bfloat16`` on bf16 x and kernel (the f32 bias), each shape
  also beside one ``F.conv2d`` in bf16 on ``channels_last`` (cuDNN: the
  library yardstick), all timed by CUDA graph replays (``chip_smoke.graph_ms``,
  as the smoke's kernel rows);
- ``--kernel decoder``: K6 (``conv_decoder``) at the decoder
  (``chip_smoke.DECODER``); plain: three cuDNN convs and the head; with
  ``--dtype bfloat16`` on bf16 x (the weights and biases rounded to bf16,
  as the model passes them), beside cuDNN's three bare bf16 ``F.conv2d`` on
  ``channels_last`` at its conv shapes (no ReLU or head: information, no
  library call computes the decoder), by graph replays; and its first two
  convs alone on K8 (``conv3x3``, the same kernel at the same shapes), so
  that the third conv's and the head's share is the rest.

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


def _cases(kernel, cs, gen, dev, dtype):
    """(name, kernel fn, plain fn, library fn or None) for each shape of
    ``kernel``."""
    import torch
    import torch.nn.functional as F

    from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
    from tomosar2height_tpu_torch.ops.cuda import convpair_kernel as cpk
    from tomosar2height_tpu_torch.ops.cuda import decoder_kernel as dk

    x_of = lambda h, c: torch.randn(8, h, h, c, generator=gen).to(dev)  # noqa: E731
    if kernel == "pair":
        bf = dtype == torch.bfloat16
        for h, cin, c, pool in cs.ALTO_PAIRS + cs.IMAGE_PAIRS:
            w1, b1, w2, b2 = (*cs._conv_w(gen, cin, c, 3, dev), *cs._conv_w(gen, c, c, 3, dev))
            if bf:
                w1, b1, w2, b2 = (t.to(dtype).float() for t in (w1, b1, w2, b2))
            a = (x_of(h, cin).to(dtype), w1, b1, w2, b2)
            lib = None
            if bf:  # cuDNN's two convs at the pair's shapes
                mid = x_of(h, c).to(dtype)
                lib = [(t.permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last), bb.to(dtype))
                    for t, k, bb in ((a[0], w1, b1), (mid, w2, b2))]
            for p in (True, False) if (pool and bf) else (pool,):
                yield (f"{h}^2 {cin}->{c}{' pool' if p else ' pool off' if pool else ''}",
                       lambda a=a, p=p: cpk.conv_pair(*a, p),
                       lambda a=a, p=p: cpk.conv_pair_plain(*a, p),
                       lib and (lambda lib=lib: [F.conv2d(*x, padding=1) for x in lib]))
    elif kernel == "conv3x3":
        for h, cin, cout in cs.CONVS:
            w, bias = cs._conv_w(gen, cin, cout, 3, dev)
            a = (x_of(h, cin).to(dtype), w.to(dtype), bias)
            lib = None
            if dtype == torch.bfloat16:
                lib = (a[0].permute(0, 3, 1, 2), a[1].permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last), bias.to(dtype))
            yield (f"{h}^2 {cin}->{cout}", lambda a=a: ck.conv3x3(*a, True),
                   lambda a=a: ck.conv3x3_plain(*a, True),
                   lib and (lambda a=lib: F.conv2d(*a, padding=1)))
    else:
        h, c0, (c1, c2, c3), co = cs.DECODER
        ws = (*cs._conv_w(gen, c0, c1, 3, dev), *cs._conv_w(gen, c1, c2, 3, dev),
              *cs._conv_w(gen, c2, c3, 3, dev), *cs._conv_w(gen, c0 + c1 + c2 + c3, co, 1, dev))
        lib = None
        if dtype == torch.bfloat16:
            ws = tuple(t.to(dtype).float() for t in ws)
            xs = [x_of(h, c).to(dtype) for c in (c0, c1, c2)]
            lib = [(t.permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last), bb.to(dtype))
                for t, k, bb in zip(xs, ws[0:6:2], ws[1:6:2])]
        a = (x_of(h, c0).to(dtype), *ws)
        yield (f"{h}^2 {c0}->{c1}->{c2}->{c3} head {co}", lambda: dk.conv_decoder(*a),
               lambda: dk.conv_decoder_plain(*a),
               lib and (lambda: [F.conv2d(*x, padding=1) for x in lib]))
        if dtype == torch.bfloat16:  # conv1 and conv2 alone, as K8 runs them
            for i, (ci, c) in enumerate(((c0, c1), (c1, c2))):
                one = (xs[i], ws[2 * i].to(dtype), ws[2 * i + 1])
                yield (f"conv{i + 1} {h}^2 {ci}->{c} alone", lambda a=one: ck.conv3x3(*a, True),
                       lambda a=one: ck.conv3x3_plain(*a, True),
                       lambda x=lib[i]: F.conv2d(*x, padding=1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--kernel", choices=("pair", "conv3x3", "decoder"), default="pair")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
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
    dtype = getattr(torch, args.dtype)
    names, kfns, pfns, lfns = zip(*_cases(args.kernel, cs, torch.Generator().manual_seed(7),
                                          dev, dtype))
    # the model's calls (each shape with its own pool flag) make the totals;
    # in bf16 the unpooled twins of the pooled pairs, and the decoder's convs
    # alone, are logged by shape only
    model = [i for i, n in enumerate(names) if not n.endswith(("pool off", "alone"))]
    total_k = [kfns[i] for i in model]
    if dtype == torch.bfloat16:  # device time by graph replays, as the smoke's rows
        def ms(fn, warmup=1):
            return cs.graph_ms(fn, args.iters, warmup)
    else:
        def ms(fn, warmup=3):
            return cs.cuda_ms(fn, args.iters, warmup)
    total = ms(lambda: [fn() for fn in total_k])
    plain = ms(lambda: [pfns[i]() for i in model])
    lib = f", library {ms(lambda: [lfns[i]() for i in model]):.4f} ms" if all(lfns) else ""
    per = "; ".join(
        f"{n} {ms(k, 1):.3f}/{ms(p, 1):.3f}" + (f"/{ms(lf, 1):.3f}" if lf else "")
        for n, k, p, lf in zip(names, kfns, pfns, lfns))
    print(f"{args.kernel} {args.dtype} {root}: {total:.4f} ms for the {len(model)} shapes, "
          f"plain {plain:.4f} ms{lib} (median of {args.iters}"
          f"{', graph replays' if dtype == torch.bfloat16 else ''}); by shape, kernel/plain"
          f"{'/library' if lib else ''} ms: {per}", flush=True)


if __name__ == "__main__":
    main()
