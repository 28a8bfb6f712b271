"""The serving loader's host time by part, on the C++ host runtime's route and
on its numpy plain versions' route, on the host that runs it:

- the flagship's serving loader (``flagship_config()``: 512 m patches at a
  256 m stride, fused2's aligned layout, 1024-cell tiles, batch 8) over the
  smoke's synthetic city (``chip_smoke.CITY``, 35 tiles), synchronous: the
  seconds of one pass in each part, summed over its patches: **crop** (the
  grid index's query, its exact filter on the C++ route), **normalize**
  (the transform, the float32 cast and the recrop), **layout** (the aligned
  Morton layout, with the padding it needs), **collate** (the rest of the
  batch assembly), and the pass's wall seconds (``total``: what serving's
  ``loader_s`` counts on the synchronous loader);
- the same pass with ``--workers`` patch threads (no prefetch thread): its
  wall seconds on each route, which shows whether the threads run side by
  side (a ctypes call releases the GIL);
- the world crop of one patch's box: the grid index's query against the C++
  runtime's scan of the whole cloud and the gather of its points
  (``geo.crop_pc_2d``), mean milliseconds a patch; the scan grows with the
  cloud, the query with the patch.

    python -m tomosar2height_tpu_torch.tools.time_loader [--repeats 5] [--workers 4]

Each number is the median over ``--repeats`` passes (host clock). Prints the
card's name and power limit where ``nvidia-smi`` finds one (the host beside
it is what is timed), then one JSON line. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import numpy as np

    import chip_smoke as cs
    from tomosar2height_tpu_torch import native
    from tomosar2height_tpu_torch.config import flagship_config
    from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset, pipeline
    from tomosar2height_tpu_torch.data.pipeline import loader_kwargs
    from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city
    from tomosar2height_tpu_torch.geo import crop

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        smi = "no card found"
    print(smi, flush=True)
    native.library()

    w, h = cs.CITY["W"], cs.CITY["H"]
    _, pts, _ = build_city(0, **cs.CITY)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + w, Y0 + h],
               "points": pts}]
    cfg = flagship_config()
    kw = {**loader_kwargs(cfg), "n_workers": 0}
    bsz = cfg["training"]["val_batch_size"]

    spent = defaultdict(float)

    def timer(part, owner, name):
        """Time ``owner.name`` into ``spent[part]``; returns the undo."""
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[part] += time.perf_counter() - t0
            return out
        setattr(owner, name, wrapped)
        return lambda: setattr(owner, name, fn)

    timer("crop", crop.GridIndex2D, "query")
    timer("normalize", SceneDataset, "_normalize_points")
    timer("collate", PatchLoader, "collate")
    # the layout: the C++ route's call (its padding inside), or the numpy
    # route's padding and layout
    layout = {"cpp": [(PatchLoader, "_align_native")],
              "numpy": [(pipeline, "pad_points"), (pipeline, "host_morton_bucket_aligned")]}

    out = {"host_cores": os.cpu_count(), "tiles": None, "parts_s": {}, "workers_s": {},
           "world_crop_ms": {}}
    for route, nat in (("cpp", True), ("numpy", False)):
        undo = [timer("layout", owner, name) for owner, name in layout[route]]
        ds = SceneDataset(chunks, cfg["dataset"], "test", native=nat)
        out["tiles"] = len(ds)
        runs = []
        for _ in range(args.repeats):
            spent.clear()
            t0 = time.perf_counter()
            for _ in PatchLoader(ds, bsz, native=nat, **kw):
                pass
            total = time.perf_counter() - t0
            parts = dict(spent)
            parts["collate"] -= parts["layout"]  # the layout runs inside collate
            runs.append({**parts, "total": total})
        out["parts_s"][route] = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
        walls = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for _ in PatchLoader(ds, bsz, native=nat, **{**kw, "n_workers": args.workers}):
                pass
            walls.append(time.perf_counter() - t0)
        out["workers_s"][route] = float(np.median(walls))
        for u in undo:
            u()
    # one patch's world crop: the grid index against a scan of the whole cloud
    ds = SceneDataset(chunks, cfg["dataset"], "test", native=True)
    boxes = [(a["anchor"], a["anchor"] + ds.patch_size) for a in ds.anchor_points]
    index = ds.data[0]["index"]
    for name, fn in (("grid_index", lambda lo, hi: index.query(pts, lo, hi)),
                     ("cpp_full_scan", lambda lo, hi: crop.crop_pc_2d(pts, lo, hi))):
        per = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for lo, hi in boxes:
                fn(lo, hi)
            per.append((time.perf_counter() - t0) / len(boxes) * 1e3)
        out["world_crop_ms"][name] = float(np.median(per))
    out["workers"] = args.workers
    out["points"] = int(len(pts))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
