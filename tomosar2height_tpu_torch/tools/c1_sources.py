"""Tell apart the sources of run-to-run differences in training.

    python -m tomosar2height_tpu_torch.tools.c1_sources [--root DIR] [--path fused2|unsorted]

Runs ``chip_smoke.train_phase``'s determinism check (the flagship training
step on random patches of the synthetic city: 1 warm-up and 2 timed
optimizer steps of 8 mini-steps, run twice from the same weights on the
same patches), on the fused2 kernel path or (``--path unsorted``) on the
unsorted point path (``dataset.points.sort: false``, the default config's:
plain segment ops, gathers and samples), under several configurations, and
prints for each how many parameter tensors differ between the two runs, the
largest difference and the largest window-loss difference:

- ``as is``: nothing changed;
- ``K4 plane plain``: K4's plane (``fused_level``'s scatter-mean) recomputed
  from the kernel's c_out on the host (float32; CPU ops are deterministic);
- ``K5 d_plane plain``: K5's d_plane recomputed from scratch in plain torch,
  the bilinear transpose on the host (float32);
- ``resize plain``: the decoder's bilinear resize differentiated through
  ``torch.matmul`` with its interpolation matrices (the JAX package's
  contraction) instead of ``F.interpolate``'s backward;
- ``cudnn deterministic``: ``torch.backends.cudnn.deterministic = True``;
- ``all``: the four together;
- ``as is + warn`` and ``all + warn``: the same under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, which names
  every op on the path that has no deterministic implementation (the
  warnings are printed once each; the mode also switches ops that have one,
  cuDNN's convolutions among them, to it).

On the unsorted path the default configurations are ``as is`` and ``as is
+ warn``: the others replace parts of the fused2 kernels, which that path
does not run. Its ops switch the mode on for themselves and back to what
it was (``ops/scatter.fixed_order``), so ``+ warn`` still names any op on
the path that has no deterministic implementation.

``--root`` is the root of a checkout (default: this one); its package and
its ``chip_smoke.py`` are imported from there, so that a parent commit can
be examined. The replacements patch functions that trees with the atomic
plane scatters and trees without them both have: ``level_kernel._fused_level``,
``level_kernel.fused_level_bwd`` and ``ops.resize.resize_bilinear`` as the
decoder imports it. Prints the card's name and power limit first. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings


def _host_scatter_mean(c_out, cells, mask, reso: int, finest: int):
    """K4's plane from its c_out: a float32 scatter-mean on the host."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda.level_kernel import level_shift
    from tomosar2height_tpu_torch.ops.scatter import segment_counts, segment_mean
    from tomosar2height_tpu_torch.ops.sorted_scatter import morton_to_plane

    c, cl, m = c_out.cpu(), cells.cpu(), mask.cpu()
    ncell = reso * reso
    cell_r = cl >> level_shift(reso, finest)
    valid = m & (cl >= 0) & (cell_r < ncell)
    idx = torch.where(valid, cell_r, torch.zeros_like(cell_r))
    counts = segment_counts(idx, ncell, valid)
    return morton_to_plane(segment_mean(c, idx, ncell, valid, counts=counts),
                           reso).to(c_out.device)


def _host_d_plane(plane, c_last, weights, xy, cells, mask, counts, g_plane, g_c, reso,
                  finest):
    """K5's d_plane in plain torch: d_s on the card (gathers and cuBLAS, both
    deterministic), the bilinear transpose on the host."""
    import torch

    from tomosar2height_tpu_torch.ops.cuda.level_kernel import level_shift
    from tomosar2height_tpu_torch.ops.cuda.pool2_kernel import pool_gather_plain
    from tomosar2height_tpu_torch.ops.sampling import grid_sample_2d, grid_sample_2d_adjoint
    from tomosar2height_tpu_torch.ops.sorted_scatter import plane_to_morton

    w_in, b_in, w_out = weights[:3]
    pre = grid_sample_2d(plane, xy) @ w_in + b_in
    scaled = plane_to_morton(g_plane / counts.clamp_min(1).to(g_plane.dtype)[..., None])
    g_pt = pool_gather_plain(scaled, cells >> level_shift(reso, finest), mask & (cells >= 0))
    d_o = torch.where(mask[..., None], g_c + g_pt, torch.zeros_like(g_c))
    d_s = ((d_o @ w_out.t()) * (pre > 0)) @ w_in.t()
    r = plane.shape[1]
    return grid_sample_2d_adjoint(d_s.cpu(), xy.cpu(), r, r).to(plane.device)


class _MatmulResize:
    """``resize_bilinear`` (align_corners=True) whose backward contracts the
    cotangent with the two interpolation matrices (torch.matmul)."""

    def __init__(self, torch):
        import torch.nn.functional as F

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, out_hw):
                ctx.hw = x.shape[1:3]
                y = F.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode="bilinear",
                                  align_corners=True)
                return y.permute(0, 2, 3, 1)

            @staticmethod
            def backward(ctx, g):
                (h, w), (ho, wo) = ctx.hw, g.shape[1:3]
                ah, aw = _interp_matrix(torch, ho, h, g), _interp_matrix(torch, wo, w, g)
                # g (B, Ho, Wo, C): contract Wo with aw, then Ho with ah
                t = torch.einsum("bhwc,wx->bhxc", g, aw)
                return torch.einsum("bhxc,hy->byxc", t, ah), None

        self.fn = Fn

    def __call__(self, x, out_hw):
        if isinstance(out_hw, int):
            out_hw = (out_hw, out_hw)
        if tuple(out_hw) == tuple(x.shape[1:3]):
            return x
        return self.fn.apply(x, tuple(out_hw))


def _interp_matrix(torch, n_out: int, n_in: int, like):
    """(n_out, n_in) align_corners=True linear interpolation weights."""
    src = torch.arange(n_out, dtype=torch.float64) * ((n_in - 1) / max(n_out - 1, 1))
    i0 = src.floor().long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    frac = src - i0.double()
    a = torch.zeros(n_out, n_in, dtype=torch.float64)
    a[torch.arange(n_out), i0] += 1 - frac
    a[torch.arange(n_out), i1] += frac
    return a.to(device=like.device, dtype=like.dtype)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--path", choices=("fused2", "unsorted"), default="fused2")
    ap.add_argument("--configs", default=None, help="default: every configuration on "
                    "fused2, 'as is,as is + warn' on the unsorted path")
    args = ap.parse_args()
    if args.configs is None:
        args.configs = ("as is,as is + warn" if args.path == "unsorted" else
                        "as is,as is + warn,K4 plane plain,K5 d_plane plain,resize plain,"
                        "cudnn deterministic,all,all + warn")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "tomosar2height_tpu_torch"]:
        del sys.modules[name]
    import numpy as np
    import torch

    import chip_smoke as cs
    from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import RasterData
    from tomosar2height_tpu_torch.models import build_model
    from tomosar2height_tpu_torch.models import decoder as dec
    from tomosar2height_tpu_torch.ops.cuda import level_kernel as lk
    from tomosar2height_tpu_torch.train import Trainer, build_scheduler, train

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this check runs only on a GPU")
    if not lk.__file__.startswith(root):
        raise RuntimeError(f"imported {lk.__file__}, not the port under {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    w, h = cs.CITY["W"], cs.CITY["H"]
    ndsm, pts, _ = build_city(0, **cs.CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    dsm = (ndsm, RasterData((X0, Y0), (X0 + w, Y0 + h), (1.0, 1.0)))
    cfg, model = cs.flagship_model(0)
    if args.path == "unsorted":
        cfg = json.loads(json.dumps(cfg))
        cfg["dataset"]["points"]["sort"] = False
        weights = model.state_dict()
        model = build_model(cfg, "cuda")
        model.load_state_dict(weights)
    tcfg, dcfg = cfg["training"], cfg["dataset"]
    bsz, k = tcfg["batch_size"], tcfg["optimize_every"]
    reso = cfg["model"]["encoder_kwargs"]["plane_resolution"]
    state0 = {n: v.detach().clone() for n, v in model.state_dict().items()}

    def run():
        ds = SceneDataset(chunks, dcfg, random_sample=True, random_length=bsz * k, dsm=dsm)
        loader = PatchLoader(ds, bsz, dcfg["points"]["bucket_sizes"],
                             fixed_bucket=dcfg["points"]["train_bucket"],
                             sort_reso=reso if args.path == "fused2" else None,
                             shuffle=True, drop_last=True, seed=0, det_stream=True)
        model.load_state_dict(state0)
        trainer = Trainer(model, tcfg)
        sched = build_scheduler(tcfg)
        warm = train(trainer, sched, loader, tcfg, max_iteration=1)
        out = train(trainer, sched, loader, tcfg, max_iteration=2)
        torch.cuda.synchronize()
        return ({n: v.detach().clone() for n, v in model.state_dict().items()},
                [r["loss"] for r in warm["windows"] + out["windows"]])

    orig_level, orig_bwd, orig_resize = lk._fused_level, lk.fused_level_bwd, dec.resize_bilinear

    def level_plain_plane(plane, c_last, weights, xy, cells, mask, reso_, finest):
        plane_out, c_out, counts = orig_level(plane, c_last, weights, xy, cells, mask,
                                              reso_, finest)
        return _host_scatter_mean(c_out, cells, mask, reso_, finest), c_out, counts

    def bwd_plain_d_plane(*a):
        d_plane, d_c_last, dw = orig_bwd(*a)
        return _host_d_plane(*a), d_c_last, dw

    @contextlib.contextmanager
    def configured(name):
        on = {name.replace(" + warn", "")}
        if "all" in on:
            on = {"K4 plane plain", "K5 d_plane plain", "resize plain", "cudnn deterministic"}
        if "K4 plane plain" in on:
            lk._fused_level = level_plain_plane
        if "K5 d_plane plain" in on:
            lk.fused_level_bwd = bwd_plain_d_plane
        if "resize plain" in on:
            dec.resize_bilinear = _MatmulResize(torch)
        prev_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = "cudnn deterministic" in on
        if name.endswith("+ warn"):
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = prev_det
            lk._fused_level, lk.fused_level_bwd = orig_level, orig_bwd
            dec.resize_bilinear = orig_resize

    tol = cs._height_tol(cfg)
    for name in args.configs.split(","):
        t0 = time.perf_counter()
        with configured(name), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (s1, l1), (s2, l2) = run(), run()
        diff = {n: float((s2[n].double() - v.double()).abs().max())
                for n, v in s1.items() if v.is_floating_point()}
        unequal = sorted(n for n, d in diff.items() if d > 0)
        by_module: dict = {}
        for n in unequal:
            key = ".".join(n.split(".")[:2])
            by_module[key] = by_module.get(key, 0) + 1
        dl = max(abs(a - b) for a, b in zip(l1, l2))
        print(f"[{args.path} {name}] {len(unequal)} of {len(diff)} tensors differ (largest max|d| "
              f"{max(diff.values()):.3g}) | window losses max|d| {dl:.3g} m (tol {tol:.3g}) "
              f"| losses {[f'{x:.6f}' for x in l1]} | by module {by_module} | "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if name.endswith("+ warn"):
            msgs = sorted({str(wm.message).split("\n")[0][:300] for wm in caught
                           if "determinis" in str(wm.message)})
            print(f"[{args.path} {name}] {len(msgs)} distinct nondeterminism warnings:",
                  flush=True)
            for m in msgs:
                print(f"  - {m}", flush=True)
        if not all(np.isfinite(l1 + l2)):
            raise AssertionError(f"{name}: losses {l1} {l2}")


if __name__ == "__main__":
    main()
