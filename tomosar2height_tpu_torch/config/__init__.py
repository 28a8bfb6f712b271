"""The port's configuration: ``compose()`` of its own YAML tree (``conf/``, a
byte-equal copy of the JAX package's), and the named configurations the
smoke, the tools and the tests build.

:func:`flagship_config` is ``compose()`` of ``dataset=berlin`` (depth-5 ALTO
U-Net, cloud only) on the fused2 kernel path; :func:`fusion_config` the
cloud+image fusion network on the same keys with the conv kernel flags
(``fused_convs`` on both U-Nets, K7; the decoder's ``fused_head``, K6);
:func:`headline_config` the same network on munich's keys (ALTO depth 6, the
footprint head); :func:`sorted_config` the flagship on another Morton-sorted
path. :func:`select_device` reads the ``device`` node.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from tomosar2height_tpu_torch.config.compose import (  # noqa: F401
    Config,
    compose,
    default_conf_dir,
    parse_cli_overrides,
)

log = logging.getLogger(__name__)

KERNEL_PATH = ["dataset.points.sort=true", "model.encoder_kwargs.sorted_impl=fused2"]
CONV_KERNELS = ["model.encoder_kwargs.unet_kwargs.fused_convs=true",
                "model.encoder2_kwargs.fused_convs=true",
                "model.decoder_pixel_kwargs.fused_head=true"]


def _compose(overrides) -> Config:
    return compose(default_conf_dir(), overrides=overrides)


def flagship_config() -> Config:
    """The flagship: ``dataset=berlin dataset.points.sort=true
    model.encoder_kwargs.sorted_impl=fused2``."""
    return _compose(["dataset=berlin"] + KERNEL_PATH)


def fusion_config() -> Config:
    """The cloud+image fusion network: the flagship plus a depth-6 image U-Net
    over the berlin RGB crop, its plane summed into the decoder's
    (``use_image=true``), with ``fused_convs`` (K7) on both U-Nets and the
    decoder's ``fused_head`` (K6)."""
    return _compose(["dataset=berlin", "use_image=true"] + KERNEL_PATH + CONV_KERNELS)


def headline_config() -> Config:
    """The paper's headline network: the fusion network on munich's keys
    (``dataset=munich use_image=true`` with the kernel flags of
    :func:`fusion_config`): ALTO depth 6, the footprint head
    (``use_footprint``), munich's image normalization and ``z_bound``."""
    return _compose(["dataset=munich", "use_image=true"] + KERNEL_PATH + CONV_KERNELS)


def sorted_config(impl: str) -> Config:
    """The flagship with ``model.encoder_kwargs.sorted_impl=impl`` ('fused',
    'pallas', 'cumsum' or 'fused2')."""
    return _compose(["dataset=berlin", "dataset.points.sort=true",
                     f"model.encoder_kwargs.sorted_impl={impl}"])


def select_device(cfg) -> torch.device:
    """The device the ``device`` node names.

    - ``platform``: null (the default) is the card, and with no card this
      raises: nothing falls back to the CPU. ``'cpu'`` is the CPU (the tests);
      ``'cuda'``/``'gpu'`` the card as null. Anything else raises.
    - ``dtype``: float32 only. The compute dtype is ``model.dtype``
      (float32 or bfloat16, ``models.build_model``); the JAX package reads
      ``device.dtype`` nowhere, and the port refuses any other value rather
      than ignore it.
    - ``mesh.data``: the port runs on one card; -1 (all cards) runs on the
      first, a count above 1 raises (ROADMAP: data parallelism).
    - ``distributed.*``: a multi-process cluster raises (ROADMAP: data
      parallelism) when any of its keys is set.
    - ``donate`` has nothing to do here: the port's optimizer updates the
      parameters in place, which is what donating buffers buys JAX.
    """
    cfg = Config(cfg)
    platform: Optional[str] = cfg.select("device.platform")
    dtype = str(cfg.select("device.dtype", "float32"))
    if dtype != "float32":
        raise NotImplementedError(
            f"device.dtype={dtype!r}: the compute dtype is model.dtype (float32 or "
            "bfloat16); device.dtype takes float32 only")
    mesh = int(cfg.select("device.mesh.data", -1) or -1)
    if mesh > 1:
        raise NotImplementedError(f"device.mesh.data={mesh}: the port runs on one card "
                                  "(ROADMAP: data parallelism)")
    dist = cfg.select("device.distributed") or {}
    if any(v is not None for v in dist.values()):
        raise NotImplementedError(f"device.distributed={dict(dist)}: multi-process runs "
                                  "are ROADMAP: data parallelism")
    if platform in (None, "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError("device.platform=null names the card, and there is no CUDA "
                               "card here; pass device.platform=cpu to run on the CPU")
        if mesh == -1 and torch.cuda.device_count() > 1:
            log.info("device.mesh.data=-1: the port runs on the first of %d cards",
                     torch.cuda.device_count())
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device.platform={platform!r}: null (the card) or 'cpu'")
