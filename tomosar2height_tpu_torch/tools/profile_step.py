"""A fused2 training mini-step on the card, with or without cuDNN's
deterministic algorithms, and the convolution kernels cuDNN ran.

    python -m tomosar2height_tpu_torch.tools.profile_step [--root DIR]
        [--deterministic 0|1] [--config flagship|headline] [--dtype bfloat16]

Builds the flagship network (``--config flagship``, the default) or the
headline network (``headline``: ``config.headline_config()``, the
cloud+image network with ALTO depth 6 and the footprint head, K6 and K7 on)
with random weights from seed 0 and a Trainer (batch 8, ``optimize_every``
8, remat) as ``chip_smoke`` does, on one batch of 8 random patches of 16384
points on the aligned layout (``chip_smoke.flagship_batch``) with random
targets (half the pixels ground) and, for the headline network, a random
normalized image. After 8 warm
mini-steps it times 16 with CUDA events (median), then records 8 with
``torch.profiler`` and prints the device time a mini-step by kernel name
for the kernels cuDNN and cuBLAS ran (names holding conv, wgrad, dgrad,
cudnn, xmma, implicit, gemm or sm90), the convolution backwards by input
shapes with their device time, the device busy time a mini-step, the peak
memory, the card's name and power limit, then the time of the port's own
kernels and the largest device kernels of any origin. ``--deterministic``
sets the step's ``cudnn.deterministic`` (1: the port's training step as
it is; 0: cuDNN free to pick any algorithm), by the scope that
``Trainer.train_step`` takes (``ops/cuda/conv_kernel.fp32_convs``); in a
tree whose step has no such choice it only sets the flag around the run.
cuDNN's choice depends on the process's history, so run each setting in a
fresh process. ``--root`` is the root of a checkout (default: this one;
``--config headline`` needs a tree that has the headline network). With
``--dtype bfloat16`` (headline only) the network runs in bf16
(``model.dtype=bfloat16``, as the smoke's phase "bf16" trains it), so that
two checkouts' bf16 mini-steps compare in one call. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

KERNEL_WORDS = ("conv", "wgrad", "dgrad", "cudnn", "xmma", "implicit", "gemm", "sm90")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--deterministic", type=int, choices=(0, 1), default=1)
    ap.add_argument("--config", choices=("flagship", "headline"), default="flagship")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    if args.dtype == "bfloat16" and args.config != "headline":
        raise SystemExit("--dtype bfloat16 takes --config headline")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import contextlib

    import numpy as np
    import torch

    import chip_smoke as cs
    from tomosar2height_tpu_torch.ops.cuda import conv_kernel as ck
    from tomosar2height_tpu_torch.tools.profile_forward import _busy_ms
    from tomosar2height_tpu_torch.train import Trainer
    from tomosar2height_tpu_torch.train import trainer as tr

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    if not ck.__file__.startswith(root):
        raise RuntimeError(f"imported {ck.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    det = bool(args.deterministic)

    @contextlib.contextmanager
    def step_scope(deterministic: bool = False):
        with ck.fp32_convs():
            prev = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = det
            try:
                yield
            finally:
                torch.backends.cudnn.deterministic = prev

    tr.fp32_convs = step_scope  # the step's scope, with this run's choice
    if args.config == "headline":
        from tomosar2height_tpu_torch.config import headline_config
        from tomosar2height_tpu_torch.models import build_model, init_weights

        cfg = headline_config()
        cfg["model"]["dtype"] = args.dtype
        model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    else:
        cfg, model = cs.flagship_model(0)
    tcfg = cfg["training"]
    _, _, apts, amask, _, toff = cs.flagship_batch(1)
    b = len(apts)
    side = cfg["model"]["decoder_pixel_kwargs"]["output_size"]
    rng = np.random.default_rng(2)
    batch = {"points": apts, "point_mask": amask, "cell_offsets": toff,
             "patch_valid": np.ones(b, bool),
             "dsm": np.where(rng.random((b, side, side)) < 0.5, 0.0,
                             rng.uniform(0, 40, (b, side, side))).astype(np.float32)}
    if args.config == "headline":
        batch["image"] = rng.normal(0, 1, (b, side, side, 3)).astype(np.float32)
        trainer = Trainer(model, tcfg, use_image=True, use_footprint=True,
                          weight_ce=tcfg["weight_ce"])
    else:
        trainer = Trainer(model, tcfg)
    dev = trainer.prepare_batch(batch)
    for _ in range(8):
        trainer.train_step(dev, 1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(16):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        trainer.train_step(dev, 1e-4)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    steps = 8
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(dev, 1e-4)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    port_kernels = cs.TENSOR_CORE_KERNELS + cs.RUN_KERNELS + ("sum_splits", "tile_gather")
    by_name: dict = {}
    every: dict = {}
    total = 0.0
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            total += ms
            every[ev.name] = every.get(ev.name, 0.0) + ms
            if (any(w in ev.name.lower() for w in KERNEL_WORDS)
                    and not any(k in ev.name for k in port_kernels)):
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    print(f"{args.config} mini-step cudnn.deterministic={det}: "
          f"{float(np.median(times)):.2f} ms "
          f"(median of 16, CUDA events; min {min(times):.2f}, max {max(times):.2f}) | "
          f"device {total / steps:.2f} ms, busy {_busy_ms(events) / steps:.2f} ms a "
          f"mini-step of {wall / steps:.2f} ms host wall (profiler on) | peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    conv = sum(by_name.values())
    print(f"cuDNN/cuBLAS kernels: {conv / steps:.2f} ms a mini-step; by kernel "
          "(ms a mini-step):", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms / steps:8.3f}  {name[:150]}", flush=True)
    port = {n: ms for n, ms in every.items() if any(k in n for k in port_kernels)}
    print(f"the port's kernels: {sum(port.values()) / steps:.2f} ms a mini-step; every "
          "device kernel by name, the largest 25 (ms a mini-step):", flush=True)
    for name, ms in sorted(every.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / steps:8.3f}  {name[:150]}", flush=True)
    shapes = [a for a in prof.key_averages(group_by_input_shape=True)
              if a.key == "aten::convolution_backward"]
    print("convolution backwards by input shapes (grad_out, input, weight; ms a "
          "mini-step, calls a mini-step):", flush=True)
    for a in sorted(shapes, key=lambda a: -a.device_time_total)[:12]:
        print(f"  {a.device_time_total / 1e3 / steps:8.3f}  {a.count / steps:4.1f}  "
              f"{str(a.input_shapes[:3])[:150]}", flush=True)


if __name__ == "__main__":
    main()
