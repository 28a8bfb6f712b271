"""Evaluation entry point (counterpart of the JAX package's ``test.py``)::

    python -m tomosar2height_tpu_torch.cli.test dataset=synthetic \
        [device.platform=cpu] [run_suffix=-v1] [test.check_point=path]

Loads ``<run dir>/check_points/model_best.ckpt`` (or ``test.check_point``;
the checkpoint file is the JAX package's too, so either package's run
serves here), generates the nDSM of the test split and writes, under
``<run dir>/tiff_test/``, ``<run_name>_dsm_<iter>.tiff``, the report
``<run_name>_dsm_<iter>_eval.txt`` against the GT nDSM under the building
masks, and the residual raster ``<run_name>_residual_<iter>.tiff``.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional

from tomosar2height_tpu_torch.cli.common import loader_kwargs, run_dir
from tomosar2height_tpu_torch.config import compose, default_conf_dir, select_device
from tomosar2height_tpu_torch.data import PatchLoader, TomoSARDataset
from tomosar2height_tpu_torch.infer import DSMEvaluator, DSMGenerator, print_statistics
from tomosar2height_tpu_torch.models import build_model
from tomosar2height_tpu_torch.train.checkpoint import DEFAULT_MODEL_FILE, CheckpointIO
from tomosar2height_tpu_torch.utils.logging import setup_logging
from tomosar2height_tpu_torch.utils.seeding import lock_seed

log = logging.getLogger("test")


def run(overrides: Optional[List[str]] = None) -> Optional[dict]:
    """Serve and evaluate from ``overrides`` (default ``sys.argv[1:]``).
    Returns ``stats`` (per mask: max, min, MAE, RMSE, abs_median, median,
    n_pixel, NMAD), ``raster`` (the generated nDSM; its band 1 is the
    residual after the write), ``generator``, ``n_iter`` and the three
    paths; None when the checkpoint does not exist."""
    cfg = compose(default_conf_dir(), overrides=sys.argv[1:] if overrides is None else overrides)
    dcfg, tcfg, dsm = cfg["dataset"], cfg["training"], cfg["dsm_generation"]
    device = select_device(cfg)
    out_dir = run_dir(cfg)
    tiff_dir = os.path.join(out_dir, "tiff_test")
    os.makedirs(tiff_dir, exist_ok=True)
    setup_logging(os.path.join(out_dir, cfg["logging"]["filename"]))
    if tcfg["lock_seed"]:
        lock_seed(0)

    dataset = TomoSARDataset("test", dcfg, random_sample=False, load_target=False,
                             load_image=cfg["use_image"])
    loader = PatchLoader(dataset, tcfg["val_batch_size"], **loader_kwargs(cfg))
    log.info("Dataset path: '%s'", dcfg["path"])
    model = build_model(cfg, device)
    io = CheckpointIO(os.path.join(out_dir, "check_points"), model=model)
    path = cfg["test"].get("check_point") or os.path.join(out_dir, "check_points",
                                                          DEFAULT_MODEL_FILE)
    log.info("Loading checkpoint: %s", path)
    try:
        loaded = io.load(path, resume_scheduler=False)
    except FileNotFoundError:
        log.error("Checkpoint does not exist, cannot proceed with inference.")
        return None
    n_iter = int(loaded.get("n_iter", 0))
    if loaded.get("loss_val_best") is not None:
        log.info("Best validation metric: %.8f", float(loaded["loss_val_best"]))

    generator = DSMGenerator(model, loader, dsm["pixel_size"],
                             half_blend_percent=dsm.get("half_blend_percent"),
                             crs_epsg=dsm.get("crs_epsg"), use_image=cfg["use_image"])
    evaluator = DSMEvaluator(dcfg["dsm_gt_path"], None, dcfg["mask_files"])
    stem = os.path.join(tiff_dir, tcfg["run_name"])
    dsm_path = f"{stem}_dsm_{n_iter:06d}.tiff"
    raster = generator.generate_dsm(dsm_path)
    log.info("nDSM saved to '%s'", dsm_path)
    stats, diff = evaluator.eval(raster.get_data(), raster.T)
    eval_path = f"{stem}_dsm_{n_iter:06d}_eval.txt"
    print_statistics(stats, f"{tcfg['run_name']}-iter{n_iter}", save_to=eval_path,
                     has_binary=evaluator.has_binary_building,
                     has_ternary=evaluator.has_ternary_building)
    log.info("Evaluation results saved to '%s'", eval_path)
    residual_path = f"{stem}_residual_{n_iter:06d}.tiff"
    raster.set_data(diff)
    raster.write_to_file(residual_path)
    log.info("Residual DSM saved to '%s'", residual_path)
    return {"stats": stats, "raster": raster, "generator": generator, "n_iter": n_iter,
            "dsm_path": dsm_path, "eval_path": eval_path, "residual_path": residual_path}


def main(overrides: Optional[List[str]] = None):
    """:func:`run`; returns the statistics (None without a checkpoint), as
    the JAX ``test.main``."""
    out = run(overrides)
    return None if out is None else out["stats"]


if __name__ == "__main__":
    main()
