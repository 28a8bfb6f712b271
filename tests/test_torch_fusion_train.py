"""Training the cloud+image fusion network with its footprint head: the port
against the JAX package on the CPU.

The fusion network cut to CPU size (plane 32, ALTO depth 3, image U-Net
depth 3, both start 8, output 32), one set of flax weights through the
bridge. The port runs fused2 with the kernel flags set (``fused_convs``,
``fused_head``; their plain versions here), the JAX package the same network
through its plain reference: the unsorted path without the kernel flags, on
the same points (it declares the same parameters). Its fused2 path is no
reference for gradients at this depth: the levels below 32^2 take float32
cumsums there, whose gradients lie up to 1.3e-3 * max|g| from the plain
path's (measured; the port's cumsums add in float64, within 1e-5 of it).

- One step's ``loss``, ``loss_l1``, ``loss_ce`` (1e-5) and gradients (the port
  in float64, at ``test_torch_train``'s 2e-4 * max|g| + 2e-4 rel; see
  ``TestTrainStep.test_gradients_match_jax`` there for why float64) against
  ``jax.value_and_grad(Trainer._loss)``, with and without the footprint head.
- The BCE on logits of +-80 against ``optax.sigmoid_binary_cross_entropy``
  (1e-6 rel), and garbage targets of invalid patches, which must not reach
  ``loss_ce``.
- A 3-window trajectory (``optimize_every`` 2) against the JAX ``Trainer``:
  window losses at 1e-4 rel, the parameters as updates at the bound that
  this network's float32 noise sets (``_params_close``); a control with
  targets raised by 1 m must fail both.
- The training loader with the image on, against the JAX ``PatchLoader`` +
  ``TomoSARDataset`` on the synthetic city (``scripts/make_synthetic_city``):
  equal batches over two epochs under ``det_stream``, and ``set_position``
  equal to JAX's, mid-epoch and past the epoch's end.
- ``headline_config()`` pinned to ``compose()``; the raises that stay.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import test_torch_train as ttt  # noqa: E402
from tomosar2height_tpu.config import compose  # noqa: E402
from tomosar2height_tpu.config.compose import default_conf_dir  # noqa: E402
from tomosar2height_tpu.data import PatchLoader as JaxPatchLoader  # noqa: E402
from tomosar2height_tpu.data import TomoSARDataset, build_dataset  # noqa: E402
from tomosar2height_tpu.geo import RasterReader  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh, replicate  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu.train.trainer import TrainState  # noqa: E402
from tomosar2height_tpu_torch.config import headline_config  # noqa: E402
from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset  # noqa: E402
from tomosar2height_tpu_torch.geo import RasterData  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.ops.sorted_scatter import (  # noqa: E402
    aligned_bucket_size,
    host_morton_bucket_aligned,
)
from tomosar2height_tpu_torch.train.trainer import Trainer, sigmoid_bce  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    load_flax_params,
    state_dict_to_flax,
)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this module runs: its CPU ops are small, and the
    test run shares the cores among its workers, where more threads a worker
    only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RESO = 32
B = 2
N = 400
OUT = 32
LRS = [1e-3, 2e-3, 3e-3]


def fusion_train_cfg(footprint: bool = True, fused: bool = True) -> dict:
    return {
        "use_cloud": True, "use_image": True, "use_footprint": footprint,
        "dataset": {"normalize": {"z_bound": [0.0, 60.0]}},
        "model": {
            "encoder": "pointnet_local_pool", "remat": True,
            "encoder_kwargs": {
                "hidden_dim": 8, "feature_dim": 8, "plane_resolution": RESO,
                "scatter_type": "max", "sorted_impl": "fused2", "unet_type": "alto",
                "unet_kwargs": {"depth": 3, "merge_mode": "concat", "start_filts": 8,
                                "fused_convs": fused}},
            "encoder2": "unet",
            "encoder2_kwargs": {"num_classes": 8, "in_channels": 3, "depth": 3,
                                "merge_mode": "concat", "start_filts": 8,
                                "fused_convs": fused},
            "decoder_pixel_kwargs": {
                "mode": "conv", "use_footprint": footprint, "hidden_dim": 8, "out_dim": 1,
                "output_size": OUT, "sample_mode": "bilinear", "leaky": False,
                "fused_head": fused},
        },
    }


def make_batches(seed: int, count: int, valid=None):
    """Aligned fused2 batches with an image and targets, half the pixels
    ground (0 m), so the footprint target has both classes."""
    rng = np.random.default_rng(seed)
    npad = aligned_bucket_size(N, RESO)
    out = []
    for _ in range(count):
        pts = np.full((B, npad, 3), 0.5, np.float32)
        mask = np.zeros((B, npad), bool)
        toff = np.zeros((B, RESO * RESO // 1024 + 1), np.int32)
        for i in range(B):
            p = rng.uniform(0.001, 0.999, (N, 3)).astype(np.float32)
            a = host_morton_bucket_aligned(p, rng.random(N) > 0.05, RESO)
            pts[i], mask[i], toff[i] = a["points"], a["mask"], a["tile_offsets"]
        dsm = np.where(rng.random((B, OUT, OUT)) < 0.5, 0.0,
                       rng.uniform(0.5, 30.0, (B, OUT, OUT))).astype(np.float32)
        out.append({"points": pts, "point_mask": mask, "cell_offsets": toff,
                    "image": rng.normal(0, 1, (B, OUT, OUT, 3)).astype(np.float32),
                    "patch_valid": np.array(valid if valid is not None else [True] * B),
                    "dsm": dsm})
    return out


def jax_batch(batch: dict) -> dict:
    """The same points on the JAX package's plain (unsorted) path."""
    return {k: v for k, v in batch.items() if k not in ("cell", "cell_offsets")}


def jax_trainer(footprint: bool) -> JaxTrainer:
    model = jax_build_model(fusion_train_cfg(footprint=True, fused=False))
    return JaxTrainer(model, {"optimize_every": 2, "wire_dsm_dtype": "float32"},
                      use_cloud=True, use_image=True, use_footprint=footprint,
                      weight_ce=10.0, mesh=make_mesh(1), donate=False)


@pytest.fixture(scope="module")
def params():
    b = make_batches(0, 1)[0]
    return jax.jit(jax_build_model(fusion_train_cfg(fused=False)).init)(
        jax.random.PRNGKey(0), jnp.asarray(b["points"]), jnp.asarray(b["point_mask"]),
        jnp.asarray(b["image"]))


def port_trainer(params, footprint: bool = True) -> Trainer:
    model = load_flax_params(build_model(fusion_train_cfg(), device="cpu"),
                             jax.tree.map(np.asarray, params))
    return Trainer(model, {"optimize_every": 2, "wire_dsm_dtype": "float32"},
                   use_image=True, use_footprint=footprint, weight_ce=10.0)


class TestFusionStep:
    @pytest.mark.parametrize("footprint", [True, False])
    def test_loss_and_gradients_match_jax(self, params, footprint):
        batch = make_batches(1, 1)[0]
        jtrainer = jax_trainer(footprint)
        jbatch = jtrainer.prepare_batch(jax_batch(batch))
        (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(jtrainer._loss, has_aux=True))(
            params, jbatch)
        trainer = port_trainer(params, footprint)
        _, m32 = trainer.loss(trainer.prepare_batch(batch))
        for k in ("loss", "loss_l1", "loss_ce"):
            np.testing.assert_allclose(float(m32[k].detach()), float(jmetrics[k]),
                                       rtol=1e-5, err_msg=k)
        assert (float(jmetrics["loss_ce"]) > 1.0) == footprint  # 10 x ~0.69
        trainer.model.double()
        dev = trainer.prepare_batch(batch)
        loss, m64 = trainer.loss({**dev, "points": dev["points"].double(),
                                  "image": dev["image"].double()})
        for k in ("loss", "loss_l1", "loss_ce"):
            np.testing.assert_allclose(float(m64[k].detach()), float(jmetrics[k]),
                                       rtol=1e-5, err_msg=k)
        names = [k for k, _ in trainer.model.named_parameters()]
        grads = torch.autograd.grad(loss, trainer.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(trainer.params, grads)]
        got = state_dict_to_flax(dict(zip(names, grads)))
        want = jax.tree.map(np.asarray, jgrads)
        if not footprint:  # the head is not in the loss: no gradient on either side
            head = got["params"]["decoder"].pop("conv_decoder_footprint")
            assert all(not np.any(v) for v in jax.tree.leaves(head))
            want["params"]["decoder"].pop("conv_decoder_footprint")
        ttt._assert_tree_close(got, want, 2e-4)


def test_bce_matches_optax_on_extreme_logits():
    logits = np.array([-80.0, -30.0, -5.0, -1e-3, 0.0, 1e-3, 5.0, 30.0, 80.0], np.float32)
    x = np.repeat(logits, 2)
    y = np.tile(np.array([0.0, 1.0], np.float32), len(logits))
    want = np.asarray(optax.sigmoid_binary_cross_entropy(jnp.asarray(x), jnp.asarray(y)))
    got = sigmoid_bce(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_invalid_patches_garbage_targets_do_not_reach_loss_ce(params):
    """A garbage target of an invalid patch (past f16's range on the default
    wire, then 'building' everywhere) leaves loss_ce as it is; loss_ce is
    weight_ce x the mean over the valid patch of optax's BCE of the logits."""
    torch.manual_seed(0)
    trainer = port_trainer(params)
    trainer.wire_dsm_dtype = np.dtype("float16")
    batch = make_batches(2, 1, valid=[True, False])[0]
    poison = dict(batch, dsm=batch["dsm"].copy())
    poison["dsm"][1] = 1e9
    clean, dirty = trainer.eval_step(batch), trainer.eval_step(poison)
    assert clean == dirty and np.isfinite(dirty["loss_ce"])
    dev = trainer.prepare_batch(batch)
    with torch.no_grad():
        _, logits = trainer.model(dev["points"], dev["point_mask"], dev["image"], None,
                                  dev["cell_offsets"])
    target = (dev["dsm"][0].float() > 1e-4).numpy().astype(np.float32)
    bce = optax.sigmoid_binary_cross_entropy(jnp.asarray(logits[0, ..., 0].numpy()),
                                             jnp.asarray(target))
    np.testing.assert_allclose(clean["loss_ce"], 10.0 * float(jnp.mean(bce)), rtol=1e-5)


@pytest.fixture(scope="module")
def trajectory(params):
    """3 windows of 2 mini-steps on both trainers from the same weights; the
    port also runs the control with targets + 1 m."""
    jtrainer = jax_trainer(True)
    state = replicate(TrainState(params, jtrainer.tx.init(params), jnp.zeros((), jnp.int32),
                                 jnp.zeros((5,), jnp.float32)), jtrainer.mesh)
    batches = make_batches(3, 6)
    jlosses = []
    for w in range(3):
        for b in batches[2 * w: 2 * w + 2]:
            state = jtrainer.train_step(state, jax_batch(b), LRS[w])
        jlosses.append([jtrainer.last_avg_loss, jtrainer.last_avg_loss_dict["loss_ce"]])
    runs = {}
    for name, shift in (("port", 0.0), ("control", 1.0)):
        trainer = port_trainer(params)
        losses = []
        for w in range(3):
            for b in batches[2 * w: 2 * w + 2]:
                trainer.train_step({**b, "dsm": b["dsm"] + np.float32(shift)}, LRS[w])
            losses.append([trainer.last_avg_loss, trainer.last_avg_loss_dict["loss_ce"]])
        runs[name] = (losses, trainer)
    return jlosses, state, runs


def _params_close(trainer, state, params0):
    """The final parameters as updates: |p_port - p_jax| / |p_jax - p_0| at
    2e-2 over all parameters and 5e-2 for each tensor. Adam moves each
    element by about lr a step whatever its gradient's size, and the footprint
    head's gradients on random targets are at rounding level for many
    elements, so rounding alone moves this network's parameters far more
    than the flagship's (the port's float32 run is 3.7e-2 overall and 0.13 in
    its worst tensor from its float64 run). The bound lies between the two
    float32 runs, JAX's and the port's (5.2e-3 and 1.2e-2 apart), and the
    control's 1.36 and 12.7 (measured)."""
    sd = {k: v.detach() for k, v in trainer.model.named_parameters()}
    got = ttt.flatten_tree(state_dict_to_flax(sd)["params"])
    want = ttt.flatten_tree(jax.tree.map(np.asarray, state.params)["params"])
    p0 = ttt.flatten_tree(jax.tree.map(np.asarray, params0)["params"])
    err = {k: np.linalg.norm(got[k] - want[k]) for k in want}
    moved = {k: np.linalg.norm(want[k] - p0[k]) for k in want}
    for k in want:
        assert err[k] <= 5e-2 * moved[k], (k, err[k], moved[k])
    total = np.sqrt(sum(e ** 2 for e in err.values()))
    assert total <= 2e-2 * np.sqrt(sum(m ** 2 for m in moved.values()))


def test_trajectory_matches_jax(trajectory, params):
    """Window losses and loss_ce at 1e-4 rel; the parameters by
    :func:`_params_close`."""
    jlosses, state, runs = trajectory
    losses, trainer = runs["port"]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert min(x[1] for x in losses) > 1.0
    _params_close(trainer, state, params)
    assert trainer.mini_step == 6 and trainer.accumulated_steps == 0


def test_perturbed_control_is_rejected(trajectory, params):
    jlosses, state, runs = trajectory
    losses, trainer = runs["control"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    with pytest.raises(AssertionError):  # the parameters alone
        _params_close(trainer, state, params)


def test_trainer_raises_for_what_is_not_ported(params):
    model = port_trainer(params).model
    with pytest.raises(NotImplementedError, match="ROADMAP: alternates"):
        Trainer(model, {"optimize_every": 1}, use_cloud=False, use_image=True)
    no_head = build_model(fusion_train_cfg(footprint=False), device="cpu")
    with pytest.raises(ValueError, match="footprint head"):
        Trainer(no_head, {"optimize_every": 1}, use_image=True, use_footprint=True)
    cfg = fusion_train_cfg()
    cfg["use_cloud"] = False
    with pytest.raises(NotImplementedError, match="ROADMAP: alternates"):
        build_model(cfg, device="cpu")


def test_headline_literal_matches_compose():
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=munich", "use_image=true", "dataset.points.sort=true",
        "model.encoder_kwargs.sorted_impl=fused2",
        "model.encoder_kwargs.unet_kwargs.fused_convs=true",
        "model.encoder2_kwargs.fused_convs=true",
        "model.decoder_pixel_kwargs.fused_head=true"])
    mine = headline_config()
    assert cfg["use_footprint"] is True and mine["use_footprint"] is True
    assert mine["model"]["encoder_kwargs"]["unet_kwargs"]["depth"] == 6
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            leaves.append((path, node))

    walk(mine, ())
    for path, value in leaves:
        node = cfg
        for k in path:
            node = node[k]
        assert node == value, path


# --- the training loader with the image, on an on-disk synthetic city -----------------

BUCKET = 2048


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    import make_synthetic_city as msc

    root = str(tmp_path_factory.mktemp("fusion_train"))
    msc.main(root, seed=2, density=0.1)
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=synthetic", f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud", f"output.output_folder={root}/generated",
        f"dataset.path={root}/generated",
        f"dataset.satellite_image.folder={root}/raster",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        "dataset.patch_size=[128,128]", f"dataset.points.bucket_sizes=[{BUCKET}]",
        f"dataset.points.train_bucket={BUCKET}", "use_image=true"])
    build_dataset(cfg, overwrite=True)
    reader = RasterReader(f"{root}/raster/rgb.tif")
    rgb = np.stack([reader.get_data(b) for b in (1, 2, 3)])
    t, (h, w) = reader.T, rgb.shape[1:]
    image = (rgb, RasterData((t.c, t.f + t.e * h), (t.c + t.a * w, t.f), (t.a, -t.e)))
    return cfg, image


def _loaders(city, n_patches=7):
    cfg, image = city
    jds = TomoSARDataset("train", cfg["dataset"], random_sample=True,
                         random_length=n_patches, load_image=True)
    chunks = [{"name": jds.chunk_info[i]["name"], "min_bound": jds.chunk_info[i]["min_bound"],
               "max_bound": jds.chunk_info[i]["max_bound"], "points": jds.data_dic[i]["inputs"]}
              for i in jds.dataset_chunk_idx_ls]
    t = jds.dsm.T
    rows, cols = jds.dsm_data.shape
    raster = RasterData((t.c, t.f + t.e * rows), (t.c + t.a * cols, t.f), (t.a, -t.e))
    mine = SceneDataset(chunks, cfg["dataset"], random_sample=True, random_length=n_patches,
                        dsm=(jds.dsm_data, raster), image=image)
    kw = dict(fixed_bucket=BUCKET, sort_reso=RESO, shuffle=True, drop_last=True,
              det_stream=True, seed=5)
    return PatchLoader(mine, 2, [BUCKET], **kw), JaxPatchLoader(jds, 2, [BUCKET], aligned=True,
                                                                 **kw)


def test_training_loader_images_match_jax(city):
    mine, ref = _loaders(city)
    assert len(mine) == len(ref) == 3
    for _ in range(2):  # two epochs: new shuffles, anchors and subsamples
        got, want = list(mine), list(ref)
        assert ttt._assert_batches_equal(got, want) == 3
    assert want[0]["image"].shape == (2, 128, 128, 3) and want[0]["dsm"].shape == (2, 128, 128)
    assert want[-1]["_stream_pos"] == (2, 3)


@pytest.mark.parametrize("pos", [(2, 1), (1, 3), (4, 0)])
def test_set_position_matches_jax(city, pos):
    """Mid-epoch, past the epoch's last batch (it rolls over to the next
    epoch's first) and at an epoch's start; then a whole epoch more."""
    mine, ref = _loaders(city)
    for loader in (mine, ref):
        loader.set_position(*pos)
    first = list(ref)
    assert first[0]["_stream_pos"][0] == (pos[0] + 1 if pos[1] == 3 else pos[0])
    assert ttt._assert_batches_equal(list(mine), first) == len(first)
    assert ttt._assert_batches_equal(list(mine), list(ref)) == 3


def test_set_position_needs_det_stream(city):
    mine, _ = _loaders(city)
    mine.det_stream = False
    with pytest.raises(ValueError, match="det_stream"):
        mine.set_position(1, 1)
