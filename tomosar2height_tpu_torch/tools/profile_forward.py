"""Where the time of one batch-8 forward goes on the card, by kernel.

    python -m tomosar2height_tpu_torch.tools.profile_forward [--variant kernels]

Builds the fusion network (``config.fusion_config()``, random weights from
seed 0) in one of three variants: ``kernels`` (fused2 + fused_convs +
fused_head: K1-K4, K6, K7), ``fast_conv`` (unsorted, every Conv3x3 on K8),
``plain`` (unsorted, no kernel); or, with ``--cloud-only``, the flagship
cloud-only network on its fused2 path. The input is one batch of 8 random
patches (16384 uniform points on the aligned layout where the variant needs
it, a random normalized 512^2 RGB crop). After two warm forwards,
``torch.profiler`` records three; the script prints the device time per
forward by kernel name (top 25), the device busy time (the union of the
kernels' intervals) against the host wall of the window, the card's name
and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _batch(sorted_layout: bool, seed: int = 1, b: int = 8, n: int = 16384,
           reso: int = 256):
    from tomosar2height_tpu_torch.ops.sorted_scatter import (
        host_morton_bucket_aligned,
        trim_aligned_batch,
    )

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.001, 0.999, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > 0.05
    image = rng.normal(0, 1, (b, 512, 512, 3)).astype(np.float32)
    if not sorted_layout:
        return pts, mask, image, None
    al = [host_morton_bucket_aligned(pts[i], mask[i], reso) for i in range(b)]
    apts, amask, _, toff = trim_aligned_batch(*(
        np.stack([a[k] for a in al]) for k in ("points", "mask", "cells", "tile_offsets")))
    return apts, amask, image, toff


def _busy_ms(events) -> float:
    """The union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=("kernels", "fast_conv", "plain"), default="kernels")
    ap.add_argument("--cloud-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    from tomosar2height_tpu_torch.config import flagship_config, fusion_config
    from tomosar2height_tpu_torch.models import build_model, init_weights
    from tomosar2height_tpu_torch.models.blocks import set_fast_conv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = flagship_config() if args.cloud_only else fusion_config()
    kernels = args.variant == "kernels"
    if not kernels:
        cfg["model"]["encoder_kwargs"]["unet_kwargs"]["fused_convs"] = False
        cfg["model"].get("encoder2_kwargs", {})["fused_convs"] = False
        cfg["model"]["decoder_pixel_kwargs"]["fused_head"] = False
    set_fast_conv(args.variant == "fast_conv")
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0)).eval()
    pts, mask, image, toff = _batch(kernels)
    up = lambda x: None if x is None else torch.from_numpy(x).cuda()  # noqa: E731
    pts, mask, toff = up(pts), up(mask), up(toff)
    image = None if args.cloud_only else up(image)

    def forward():
        model(pts, mask, image, None, toff, footprint=False)

    with torch.inference_mode():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        n = 3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                forward()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    busy = _busy_ms(events) / n
    by_name: dict = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    total = sum(by_name.values())
    print(f"variant {'cloud-only fused2' if args.cloud_only else args.variant}: device "
          f"{total:.2f} ms per forward (busy {busy:.2f} ms) of {wall:.2f} ms host wall "
          f"(profiler on)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms:9.3f} ms  {100 * ms / total:5.1f}%  {name[:110]}")
    print(json.dumps({"variant": args.variant, "cloud_only": args.cloud_only,
                      "device_ms": total, "busy_ms": busy, "wall_ms": wall,
                      "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:40]}))


if __name__ == "__main__":
    main()
