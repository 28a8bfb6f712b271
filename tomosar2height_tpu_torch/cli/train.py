"""Training entry point (counterpart of the JAX package's ``train.py``)::

    python -m tomosar2height_tpu_torch.cli.train dataset=synthetic \
        [device.platform=cpu] [run_suffix=-v1] [key=value ...]

The run directory ``<training.out_dir>/<training.run_name><run_suffix>``
holds ``check_points/`` (``model_<n>.ckpt`` every ``checkpoint_every``,
``model_best.ckpt`` on the best validation ``model_selection_metric``),
``tiff/`` (the vis split's nDSM every ``visualize_every``), ``wandb/
metrics.jsonl`` and the log. Seeds locked with ``training.lock_seed``;
``training.resume_from`` names a checkpoint to resume from (a missing file
trains from scratch). The device is ``device.platform`` (null: the card).
Training runs on the unsorted path or on fused2 (``dataset.points.sort=true
model.encoder_kwargs.sorted_impl=fused2``); the other sorted layouts are
ROADMAP: training on the other sorted layouts.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional

import torch

from tomosar2height_tpu_torch.cli.common import loader_kwargs, run_dir
from tomosar2height_tpu_torch.config import compose, default_conf_dir, select_device
from tomosar2height_tpu_torch.data import PatchLoader, TomoSARDataset
from tomosar2height_tpu_torch.infer import DSMEvaluator, DSMGenerator
from tomosar2height_tpu_torch.models import build_model, init_weights
from tomosar2height_tpu_torch.train import Trainer, build_scheduler, train
from tomosar2height_tpu_torch.train.checkpoint import CheckpointIO
from tomosar2height_tpu_torch.utils.logging import MetricLogger, setup_logging
from tomosar2height_tpu_torch.utils.seeding import lock_seed

log = logging.getLogger("train")


def run(overrides: Optional[List[str]] = None) -> dict:
    """Train from ``overrides`` (default ``sys.argv[1:]``). Returns the
    loop's record (``train/loop.train``) with ``trainer`` and ``run_dir``."""
    cfg = compose(default_conf_dir(), overrides=sys.argv[1:] if overrides is None else overrides)
    tcfg, dcfg = cfg["training"], cfg["dataset"]
    device = select_device(cfg)
    impl = cfg["model"]["encoder_kwargs"].get("sorted_impl", "cumsum")
    if dcfg["points"].get("sort", False) and impl != "fused2":
        raise NotImplementedError(f"training on sorted_impl={impl!r}: ROADMAP: training on "
                                  "the other sorted layouts")
    out_dir = run_dir(cfg)
    tiff_dir = os.path.join(out_dir, "tiff")
    os.makedirs(tiff_dir, exist_ok=True)
    setup_logging(os.path.join(out_dir, cfg["logging"]["filename"]),
                  cfg["logging"]["console_level"], cfg["logging"]["file_level"])
    if tcfg["lock_seed"]:
        lock_seed(0)
    logger = MetricLogger().init(
        project="tomosar2height", config=cfg.to_dict(), name=os.path.basename(out_dir),
        dir=os.path.join(out_dir, "wandb"), mode="online" if cfg["wandb"] else "disabled")

    datasets = {key: TomoSARDataset(
        key, dcfg, random_sample=key == "train",
        random_length=tcfg["random_dataset_length"] if key == "train" else None,
        flip_augm=tcfg["augmentation"]["flip"] if key == "train" else False,
        rotate_augm=tcfg["augmentation"]["rotate"] if key == "train" else False,
        load_target=key != "vis", load_image=cfg["use_image"])
        for key in ("train", "val", "vis")}
    common = loader_kwargs(cfg)
    loaders = {
        # det_stream under lock_seed: every batch a pure function of (seed,
        # epoch, position), which the checkpoints record
        "train": PatchLoader(datasets["train"], tcfg["batch_size"], shuffle=True,
                             drop_last=True, det_stream=bool(tcfg["lock_seed"]), **common),
        "val": PatchLoader(datasets["val"], tcfg["val_batch_size"], **common),
        "vis": PatchLoader(datasets["vis"], tcfg["val_batch_size"], **common),
    }
    log.info("Training data: n_data=%d, batch_size=%d; validation n_data=%d; device %s",
             len(datasets["train"]), tcfg["batch_size"], len(datasets["val"]), device)

    model = init_weights(build_model(cfg, device), torch.Generator().manual_seed(0))
    trainer = Trainer(model, tcfg, use_cloud=cfg["use_cloud"], use_image=cfg["use_image"],
                      use_footprint=cfg["use_footprint"], weight_ce=tcfg["weight_ce"])
    scheduler = build_scheduler(tcfg)
    log.info("Total model parameters: %d", sum(p.numel() for p in model.parameters()))
    logger.watch(trainer.module_norms, log_freq=tcfg["print_every"])

    dsm = cfg["dsm_generation"]
    generator = DSMGenerator(model, loaders["vis"], dsm["pixel_size"],
                             half_blend_percent=dsm.get("half_blend_percent"),
                             crs_epsg=dsm.get("crs_epsg"), use_image=cfg["use_image"])
    evaluator = DSMEvaluator(dcfg["dsm_gt_path"], None,
                             {"building": dcfg["mask_files"]["building"]})

    def visualize(n_iter: int) -> dict:
        raster = generator.generate_dsm(
            os.path.join(tiff_dir, f"{tcfg['run_name']}_dsm_{n_iter:06d}.tiff"))
        stats, _ = evaluator.eval(raster.get_data(), raster.T)
        return {f"nDSM/{k}/{k2}": v2 for k, v in stats.items() for k2, v2 in v.items()}

    out = train(trainer, scheduler, loaders["train"], tcfg, val_loader=loaders["val"],
                checkpoint_io=CheckpointIO(os.path.join(out_dir, "check_points")),
                resume_from=tcfg.get("resume_from"), metric_logger=logger,
                visualize=visualize)
    log.info("Optimization done!")
    logger.finish()
    return {**out, "trainer": trainer, "run_dir": out_dir}


def main(overrides: Optional[List[str]] = None):
    """:func:`run`; returns (trainer, iterations, best validation metric),
    as the JAX ``train.main`` returns (state, n_iter, best)."""
    out = run(overrides)
    return out["trainer"], out["n_iter"], out["loss_val_best"]


if __name__ == "__main__":
    main()
