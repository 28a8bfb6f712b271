"""The flagship serving and training configuration as a dict literal.

The JAX package composes its config from YAML (``tomosar2height_tpu/config``);
the port's serving and training paths need only these values, so it carries
them as a literal and reads no YAML. They equal ``compose()`` of ``dataset=berlin``
(depth-5 ALTO U-Net, cloud only) with ``dataset.points.sort=true`` and
``model.encoder_kwargs.sorted_impl=fused2`` (pinned by a test).
:func:`fusion_config` is the cloud+image fusion network on the same keys
(``use_image=true`` with the kernel flags set, also pinned),
:func:`headline_config` the same network on munich's keys (ALTO depth 6, the
footprint head), and :func:`sorted_config` the flagship on another
Morton-sorted path.
"""

from __future__ import annotations

import copy

_FLAGSHIP = {
    "use_cloud": True,
    "use_image": False,
    "use_footprint": False,
    "model": {
        "encoder": "pointnet_local_pool",
        "encoder_kwargs": {
            "hidden_dim": 32, "feature_dim": 32, "plane_resolution": 256,
            "scatter_type": "max", "sorted_impl": "fused2", "unet_type": "alto",
            "unet_kwargs": {"depth": 5, "merge_mode": "concat", "start_filts": 32},
        },
        "decoder_pixel_kwargs": {
            "mode": "conv", "use_footprint": False, "hidden_dim": 32, "out_dim": 1,
            "output_size": 512, "sample_mode": "bilinear", "leaky": False,
        },
        "remat": True,
    },
    "dataset": {
        "patch_size": [512, 512],
        "sliding_window": {"test_strip": [256, 256], "val_strip": [512, 512]},
        "normalize": {"x_range": [0.0, 1.0], "y_range": [0.0, 1.0],
                      "z_shift": "local_min", "z_bound": [-33.7, 156.5]},
        "points": {"bucket_sizes": [2048, 4096, 8192, 16384, 32768, 65536],
                   "train_bucket": 16384, "sort": True},
    },
    "training": {
        "batch_size": 8, "val_batch_size": 8, "optimize_every": 8,
        "grad_reduction": "mean", "wire_dsm_dtype": "float16",
        "learning_rate": 0.0001,
        "scheduler": {"type": "CyclicLR", "kwargs": {
            "base_lr": 0.0001, "max_lr": 0.0005, "mode": "triangular2",
            "gamma": 1.0, "step_size_up": 500, "step_size_down": 500}},
        "random_dataset_length": 6400, "lock_seed": True, "weight_ce": 10.0,
        "augmentation": {"flip": False, "rotate": False},
        "max_iteration": 10000, "print_every": 1, "validate_every": 100,
        "checkpoint_every": 100, "model_selection_metric": "loss_l1",
    },
    "dsm_generation": {"pixel_size": [1, 1], "half_blend_percent": [0.5, 0.5],
                       "crs_epsg": 25833},
}


def flagship_config() -> dict:
    """A fresh copy of the flagship config."""
    return copy.deepcopy(_FLAGSHIP)


def fusion_config() -> dict:
    """The cloud+image fusion network: the flagship plus a depth-6 image
    U-Net over the berlin RGB crop, its plane summed into the decoder's;
    ``compose()`` of ``dataset=berlin use_image=true dataset.points.sort=true
    model.encoder_kwargs.sorted_impl=fused2`` with ``fused_convs`` (K7) on
    both U-Nets and the decoder's ``fused_head`` (K6)."""
    cfg = flagship_config()
    cfg["use_image"] = True
    model = cfg["model"]
    model["encoder_kwargs"]["unet_kwargs"]["fused_convs"] = True
    model["encoder2"] = "unet"
    model["encoder2_kwargs"] = {"num_classes": 32, "in_channels": 3, "depth": 6,
                                "merge_mode": "concat", "start_filts": 32,
                                "fused_convs": True}
    model["decoder_pixel_kwargs"]["fused_head"] = True
    cfg["dataset"]["satellite_image"] = {"normalize": {
        "mean": [688.8, 521.7, 239.2], "std": [344.1, 291.0, 247.2]}}
    return cfg


def headline_config() -> dict:
    """The paper's headline network: the fusion network on munich's keys,
    ``compose()`` of ``dataset=munich use_image=true dataset.points.sort=true
    model.encoder_kwargs.sorted_impl=fused2`` with the kernel flags of
    :func:`fusion_config`: ALTO depth 6, the footprint head
    (``use_footprint``), munich's image normalization and ``z_bound``."""
    cfg = fusion_config()
    cfg["use_footprint"] = True
    cfg["model"]["encoder_kwargs"]["unet_kwargs"]["depth"] = 6
    cfg["model"]["decoder_pixel_kwargs"]["use_footprint"] = True
    cfg["dataset"]["satellite_image"]["normalize"] = {
        "mean": [885.1, 823.6, 622.6], "std": [406.0, 350.2, 332.9]}
    cfg["dataset"]["normalize"]["z_bound"] = [465.5, 599.5]
    cfg["dsm_generation"]["crs_epsg"] = 25832
    return cfg


def sorted_config(impl: str) -> dict:
    """The flagship with ``model.encoder_kwargs.sorted_impl=impl`` ('fused',
    'pallas', 'cumsum' or 'fused2'): ``compose()`` of ``dataset=berlin
    dataset.points.sort=true model.encoder_kwargs.sorted_impl=<impl>``."""
    cfg = flagship_config()
    cfg["model"]["encoder_kwargs"]["sorted_impl"] = impl
    return cfg
