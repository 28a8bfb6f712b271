"""TomoSAR2Height model shell: point encoder (+ image U-Net) + pixel decoder
+ z-rescale. Counterpart of ``tomosar2height_tpu/models/model.py``
(reference model.py:8-86).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tomosar2height_tpu_torch.models.blocks import DTYPES
from tomosar2height_tpu_torch.models.decoder import PixelwiseDecoder
from tomosar2height_tpu_torch.models.pointnet import LocalPoolPointnet
from tomosar2height_tpu_torch.models.unet import UNet
from tomosar2height_tpu_torch.ops.sorted_scatter import dequantize_points


class TomoSAR2Height(nn.Module):
    """Flagship network; build it with :func:`build_model` from the config."""

    def __init__(self, use_cloud: bool = True, use_image: bool = False,
                 encoder: str = "pointnet_local_pool",
                 encoder_kwargs: Optional[Dict[str, Any]] = None,
                 encoder2: str = "unet",
                 encoder2_kwargs: Optional[Dict[str, Any]] = None,
                 decoder_kwargs: Optional[Dict[str, Any]] = None,
                 z_scale: float = 1.0, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not use_cloud:
            raise NotImplementedError("the image-only network is not ported (ROADMAP: alternates)")
        if use_image and encoder2 != "unet":
            raise NotImplementedError(
                f"encoder2={encoder2!r}: only the U-Net image encoder is ported "
                "(ROADMAP: alternates)")
        if encoder != "pointnet_local_pool":
            raise NotImplementedError(
                f"encoder={encoder!r} is not ported yet (ROADMAP: alternates)")
        kwargs = dict(encoder_kwargs or {})
        self.point_encoder = LocalPoolPointnet(**kwargs, dtype=dtype)
        self.image_encoder = (UNet(**dict(encoder2_kwargs or {}), dtype=dtype)
                              if use_image else None)
        self.decoder = PixelwiseDecoder(kwargs.get("feature_dim", 32),
                                        **dict(decoder_kwargs or {}), dtype=dtype)
        self.z_scale = float(z_scale)
        # rematerialize the point encoder (ALTO U-Net included) in the
        # backward, as the JAX model's nn.remat (models/model.py:46-49,90-91):
        # its activations are dropped after the forward and recomputed, K1-K4
        # included, when the backward needs them
        self.remat = bool(remat)

    def forward(self, input_cloud: torch.Tensor, cloud_mask: torch.Tensor,
                input_image: Optional[torch.Tensor] = None,
                cloud_cells: Optional[torch.Tensor] = None,
                cloud_offsets: Optional[torch.Tensor] = None, footprint: bool = True):
        """(B, N, 3) padded normalized points, (B, N) mask, with ``use_image``
        the (B, H, W, 3) NHWC normalized image (+ aligned-layout metadata) ->
        (height (B, S, S, out_dim) in meters, footprint logits or None): the
        JAX model's signature. ``footprint=False`` skips the footprint head,
        as the JAX generator's jit drops it (infer/generator.py:285). Points
        on the u16 wire (uint16) are dequantized first, by the loader's f32
        multiply (models/model.py:78-84), so the cell ids recomputed from them
        are the loader's."""
        if input_cloud.dtype == torch.uint16:
            input_cloud = dequantize_points(input_cloud)
        elif not input_cloud.is_floating_point():
            raise TypeError(f"points: float or uint16 (the u16 wire), got {input_cloud.dtype}")
        if self.image_encoder is not None and input_image is None:
            raise ValueError("use_image: the model needs input_image (B, H, W, 3)")
        args = (input_cloud, cloud_mask, cloud_cells, cloud_offsets)
        if self.remat and torch.is_grad_enabled():
            planes = checkpoint(self.point_encoder, *args, use_reentrant=False)
        else:
            planes = self.point_encoder(*args)
        if self.image_encoder is not None:
            planes = {**planes, "image": self.image_encoder(input_image)}
        pa, pb = self.decoder(planes, footprint)
        # float32 whatever the compute dtype, the z-rescale included (JAX
        # models/model.py:114-119; reference model.py:67)
        return pa.float() * self.z_scale, (None if pb is None else pb.float())


def build_model(cfg, device="cuda") -> TomoSAR2Height:
    """Build the network from the global config tree (same keys as the JAX
    package's ``build_model``) on ``device``: the card unless the caller asks
    for ``"cpu"``; there is no fallback. Seeded weights:
    ``blocks.init_weights`` (equal on every device). ``model.dtype`` is the
    compute dtype, 'float32' or 'bfloat16' (float32 parameters either way);
    bf16 runs on the unsorted point path only and raises with
    ``dataset.points.sort`` (ROADMAP: bf16)."""
    cfg_model = cfg["model"]
    name = str(cfg_model.get("dtype", "float32"))
    if name not in DTYPES:
        raise NotImplementedError(f"model.dtype={name!r}: one of {tuple(DTYPES)}")
    dtype = DTYPES[name]
    if dtype != torch.float32 and (cfg["dataset"].get("points") or {}).get("sort", False):
        raise NotImplementedError(
            f"model.dtype={name!r} with dataset.points.sort=true: the sorted layouts' "
            "kernels run in float32 only (ROADMAP: bf16)")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA card here; pass device='cpu' to "
                           "build on the CPU")
    z_bound = cfg["dataset"]["normalize"]["z_bound"]
    model = TomoSAR2Height(
        use_cloud=bool(cfg["use_cloud"]),
        use_image=bool(cfg["use_image"]),
        encoder=cfg_model.get("encoder", "pointnet_local_pool"),
        encoder_kwargs=dict(cfg_model.get("encoder_kwargs", {}) or {}),
        encoder2=cfg_model.get("encoder2", "unet"),
        encoder2_kwargs=dict(cfg_model.get("encoder2_kwargs", {}) or {}),
        decoder_kwargs=dict(cfg_model.get("decoder_pixel_kwargs", {}) or {}),
        z_scale=float(z_bound[1]) - float(z_bound[0]),
        remat=bool(cfg_model.get("remat", False)),
        dtype=dtype,
    )
    return model.to(device)
