"""The unsorted point path (``dataset.points.sort: false``, the default
config's), timed on the card end to end, from the port in a given checkout:

- serving the synthetic city (``chip_smoke.CITY``) with its RGB image, batch
  8: the fusion network (``fusion_config()``) unsorted with the kernel flags
  off in float32 (smoke phase "fusion-serve"'s ``plain`` variant), and the
  headline network unsorted in bf16 under FAST_CONV (phase "bf16"'s ``bf16
  fast_conv``): tiles/s of the second ``generate_dsm`` (host clock), and
  forward ms of one batch (CUDA events, median of 5); beside them, for
  comparison, the same of the headline network in bf16 on its fused2
  kernel path (``headline_bf16()``, phase "bf16"'s ``bf16``: K1-K7 at their
  bf16 instances);
- training the headline network on the unsorted path, ``optimize_every``
  4, on the smoke's patches: in float32 with the kernel flags off (phase
  "headline-train"'s ``plain`` run) and in bf16 with them on
  (``chip_smoke.headline_unsorted``): a warm-up and a timed optimizer step,
  the timed step's median mini-step ms (CUDA events).

    python -m tomosar2height_tpu_torch.tools.time_unsorted [--root DIR]

``--root`` is the root of a checkout (default: this one); its package and
its ``chip_smoke.py`` are imported from there, so that two commits can be
compared on one card in one call, in turns (parent, change, change,
parent). Prints the card's name and power limit, then one line of the
numbers. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import numpy as np
    import torch

    import chip_smoke as cs
    from tomosar2height_tpu_torch.config import fusion_config
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import RasterData
    from tomosar2height_tpu_torch.infer.generator import make_generator
    from tomosar2height_tpu_torch.models import build_model, init_weights
    from tomosar2height_tpu_torch.models.blocks import set_fast_conv
    from tomosar2height_tpu_torch.ops.cuda import runtime
    from tomosar2height_tpu_torch.train import train

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this timing runs only on a GPU")
    if not runtime.__file__.startswith(root):
        raise RuntimeError(f"imported {runtime.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime.library()

    w, h = cs.CITY["W"], cs.CITY["H"]
    _, pts, rgb = build_city(0, **cs.CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    image = (rgb, RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0)))
    plain_fusion = json.loads(json.dumps(fusion_config()))
    plain_fusion["dataset"]["points"]["sort"] = False
    plain_fusion["model"]["encoder_kwargs"]["unet_kwargs"]["fused_convs"] = False
    plain_fusion["model"]["encoder2_kwargs"]["fused_convs"] = False
    plain_fusion["model"]["decoder_pixel_kwargs"]["fused_head"] = False
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, cfg, fast in (("serve f32 plain", plain_fusion, False),
                                 ("serve bf16 fast_conv", cs.headline_bf16(sort=False), True),
                                 ("serve bf16 fused2 (kernel path)", cs.headline_bf16(), False)):
            model = init_weights(build_model(cfg, "cuda"),
                                 torch.Generator().manual_seed(0)).eval()
            set_fast_conv(fast)
            try:
                gen = make_generator(model, cfg, chunks, image=image)
                batch = next(iter(gen.data_loader))
                up = {k: torch.from_numpy(batch[k]).to("cuda")
                      for k in ("points", "point_mask", "image", "cell_offsets") if k in batch}
                with torch.inference_mode():
                    fwd = cs.cuda_ms(lambda: model(up["points"], up["point_mask"],
                                                   up["image"], None, up.get("cell_offsets"),
                                                   footprint=False),
                                     iters=5, warmup=1)
                gen.generate_dsm(os.path.join(tmp, "warmup.tif"))
                torch.cuda.synchronize()
                gen.generate_dsm(os.path.join(tmp, "timed.tif"))
                torch.cuda.synchronize()
            finally:
                set_fast_conv(False)
            out[label] = {"tiles_s": gen.last_stats["patches_per_s"], "forward_ms": fwd}
            del gen, model
        for label, cfg in (("train f32 plain", cs.headline_unsorted("float32", fused=False)),
                           ("train bf16", cs.headline_unsorted("bfloat16"))):
            cfg, tcfg, loader = cs._headline_parts(0, False, cfg)
            model = init_weights(build_model(cfg, "cuda"), torch.Generator().manual_seed(0))
            trainer, sched = cs._headline_trainer(cfg, tcfg, model)
            torch.cuda.reset_peak_memory_stats()
            train(trainer, sched, loader, tcfg, max_iteration=1)
            r = train(trainer, sched, loader, tcfg, max_iteration=1)
            torch.cuda.synchronize()
            out[label] = {"mini_step_ms": r["median_step_ms"],
                          "n": r["n_ministeps"], "peak_gib": torch.cuda.max_memory_allocated()
                          / 2**30}
            del trainer, sched, model
    print(f"unsorted {root}: " + " | ".join(
        f"{k}: " + ", ".join(f"{n} {v:.4f}" if isinstance(v, float) else f"{n} {v}"
                             for n, v in d.items()) for k, d in out.items()), flush=True)
    assert all(np.isfinite(v) for d in out.values() for v in d.values())


if __name__ == "__main__":
    main()
