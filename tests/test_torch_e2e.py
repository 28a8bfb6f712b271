"""End to end through the port's entry points on the CPU, the port of
``tests/test_e2e.py`` with augmentation off: a small synthetic city written by
``write_city`` -> ``python -m tomosar2height_tpu_torch.cli.build_dataset`` ->
``cli.train`` (2 iterations of the cloud + image + footprint network on the
fused2 kernel path, whose wrappers run their plain versions on CPU tensors)
-> the artifacts on disk -> ``cli.test``'s nDSM, report and residual -> a
resume to iteration 3. The JAX ``test.py`` serves the port's
``model_best.ckpt`` (on its plain path: the fused2 and plain networks
declare the same tree) to a raster within 2e-4 x the z-range of the port's
``cli.test`` raster, with equal NaN masks."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tomosar2height_tpu_torch.cli import test as cli_test  # noqa: E402
from tomosar2height_tpu_torch.cli import train as cli_train  # noqa: E402
from tomosar2height_tpu_torch.data.synthetic import Y0, write_city  # noqa: E402
from tomosar2height_tpu_torch.geo import RasterReader  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "TomoSAR2Height-synthetic"
KERNEL_PATH = ["dataset.points.sort=true", "model.encoder_kwargs.sorted_impl=fused2",
               "model.encoder_kwargs.unet_kwargs.fused_convs=true",
               "model.encoder2_kwargs.fused_convs=true",
               "model.decoder_pixel_kwargs.fused_head=true"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the test run shares the cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(root):
    return [
        "dataset=synthetic", f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud", f"output.output_folder={root}/generated",
        f"dataset.path={root}/generated", f"dataset.satellite_image.folder={root}/raster",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        f"training.out_dir={root}/outputs",
        # a 512 x 256 m city in two 256 m chunks, 128 m patches, a tiny network
        "chunk.chunk_x=[0.0,256.0,512.0]", f"chunk.chunk_y=[{Y0},{Y0 + 256.0}]",
        "dataset.patch_size=[128,128]", "dataset.sliding_window.val_strip=[256,256]",
        "dataset.sliding_window.vis_strip=[128,128]",
        "dataset.sliding_window.test_strip=[128,128]",
        "dataset.points.bucket_sizes=[2048]", "dataset.points.train_bucket=2048",
        "use_image=true", "use_footprint=true",
        "model.encoder_kwargs.plane_resolution=32", "model.encoder_kwargs.hidden_dim=8",
        "model.encoder_kwargs.feature_dim=8", "model.encoder_kwargs.unet_kwargs.depth=2",
        "model.encoder_kwargs.unet_kwargs.start_filts=8", "model.encoder2_kwargs.num_classes=8",
        "model.encoder2_kwargs.depth=2", "model.encoder2_kwargs.start_filts=8",
        "model.decoder_pixel_kwargs.hidden_dim=8", "model.decoder_pixel_kwargs.output_size=128",
        "training.batch_size=2", "training.optimize_every=2", "training.max_iteration=2",
        "training.val_batch_size=2", "training.random_dataset_length=16",
        "training.validate_every=1", "training.checkpoint_every=1",
        "training.visualize_every=2", "training.augmentation.flip=false",
        "training.augmentation.rotate=false"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_e2e"))
    write_city(root, seed=0, density=0.15, W=512, H=256)
    ov = overrides(root)
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-m", "tomosar2height_tpu_torch.cli.build_dataset"]
                       + ov, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = cli_train.run(ov + ["device.platform=cpu"] + KERNEL_PATH)
    return root, ov + ["device.platform=cpu"], out


def run_dir(root, suffix=""):
    return os.path.join(root, "outputs", RUN + suffix)


def test_train_ran(trained):
    root, ov, out = trained
    assert out["n_iter"] == 2 and not out["resumed"]
    assert np.isfinite(out["loss_val_best"])
    assert [w["iteration"] for w in out["windows"]] == [1, 2]
    assert all(np.isfinite(w["loss"]) and w["loss_ce"] > 0 for w in out["windows"])
    assert [v["iteration"] for v in out["val"]] == [1, 2]
    assert [v["iteration"] for v in out["vis"]] == [2]
    assert out["vis"][0]["nDSM/building/n_pixel"] > 0


def test_artifacts_on_disk(trained):
    root, ov, out = trained
    run = run_dir(root)
    for name in ("check_points/model_1.ckpt", "check_points/model_2.ckpt",
                 "check_points/model_best.ckpt", "wandb/metrics.jsonl", "logging.log",
                 f"tiff/{RUN}_dsm_000002.tiff"):
        assert os.path.exists(os.path.join(run, name)), name
    assert sorted(os.listdir(os.path.join(root, "generated"))) == [
        "chunk_000", "chunk_001", "chunk_info.yaml"]


def test_metrics_jsonl(trained):
    root, ov, out = trained
    with open(os.path.join(run_dir(root), "wandb", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["_event"] == "init" and recs[0]["config"]["use_image"] is True
    steps = {r["_step"]: r for r in recs[1:]}
    assert sorted(steps) == [1, 2]
    for n, rec in steps.items():
        w = out["windows"][n - 1]
        assert rec["iteration"] == n and rec["train/loss"] == pytest.approx(w["loss"])
        assert rec["train/loss_ce"] == pytest.approx(w["loss_ce"])
        assert rec["val/loss_l1"] == pytest.approx(out["val"][n - 1]["loss_l1"])
        assert rec["misc/host_rss_bytes"] > 0 and rec["misc/time_step_s"] > 0
        assert {"point_encoder", "image_encoder", "decoder"} == {
            k.split("/")[-1] for k in rec if k.startswith("watch/param_norm/")}
    assert steps[2]["nDSM/overall/RMSE"] == pytest.approx(out["vis"][0]["nDSM/overall/RMSE"])
    assert "nDSM/overall/RMSE" not in steps[1]


def test_generated_dsm_georeferenced(trained):
    root, ov, out = trained
    r = RasterReader(os.path.join(run_dir(root), "tiff", f"{RUN}_dsm_000002.tiff"))
    # the vis chunk is chunk 1: x in [256, 512], y in [Y0, Y0 + 256]
    assert r.shape == (256, 256) and r.crs_epsg == 25832
    assert r.T.c == 256.0 and r.T.f == Y0 + 256.0 and r.pixel_size == [1.0, 1.0]
    data = r.get_data()
    assert np.isfinite(data).all() and (data >= 0).all()


def test_test_entry_point(trained):
    root, ov, out = trained
    res = cli_test.run(ov + KERNEL_PATH)
    stats = res["stats"]
    assert res["n_iter"] in (1, 2)
    assert stats["overall"]["RMSE"] is not None and stats["building"]["n_pixel"] > 0
    assert {"residential", "non_residential"} <= set(stats)
    dsm = RasterReader(res["dsm_path"]).get_data()
    residual = RasterReader(res["residual_path"]).get_data()
    gt = RasterReader(f"{root}/raster/ndsm.tif").get_data()[:, 256:]
    np.testing.assert_array_equal(residual, dsm - gt)  # every pixel under the GT mask
    with open(res["eval_path"]) as f:
        report = f.read()
    assert f"{RUN}-iter{res['n_iter']}" in report and "Residential" in report
    assert f"{stats['overall']['RMSE']:.4f}" in report


def test_jax_test_serves_the_port_checkpoint(trained):
    """ROADMAP's done condition for datasets on disk, config, CLI and
    evaluation."""
    root, ov, out = trained
    port = cli_test.run(ov + KERNEL_PATH)
    spec = importlib.util.spec_from_file_location("jax_test_entry",
                                                  os.path.join(REPO, "test.py"))
    jax_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_test)
    jax_ov = [o for o in ov if not o.startswith("device.platform")] + [
        "run_suffix=-jax", f"test.check_point={run_dir(root)}/check_points/model_best.ckpt"]
    stats = jax_test.main(jax_ov)
    path = os.path.join(run_dir(root, "-jax"), "tiff_test",
                        os.path.basename(port["dsm_path"]))
    mine, ref = port["raster"], RasterReader(path)
    assert mine.T.coefficients() == ref.T.coefficients()
    a = RasterReader(port["dsm_path"]).get_data()
    b = ref.get_data()
    nan = np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), nan)
    z = (0.0, 60.0)  # conf/dataset/synthetic.yaml's z_bound
    np.testing.assert_allclose(a[~nan], b[~nan], rtol=0, atol=2e-4 * (z[1] - z[0]))
    assert stats["overall"]["n_pixel"] == port["stats"]["overall"]["n_pixel"]


def test_card_required_unless_cpu(trained):
    root, ov, out = trained
    if torch.cuda.is_available():
        pytest.skip("a card is present: device.platform=null runs on it")
    no_platform = [o for o in ov if not o.startswith("device.platform")]
    for entry in (cli_train.run, cli_test.run):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            entry(no_platform)


def test_resume_from_checkpoint(trained):
    root, ov, out = trained
    ckpt = f"{run_dir(root)}/check_points/model_2.ckpt"
    trainer, n_iter, best = cli_train.main(ov + KERNEL_PATH + [
        f"training.resume_from={ckpt}", "training.max_iteration=3"])
    assert n_iter == 3 and np.isfinite(best)
    assert os.path.exists(f"{run_dir(root)}/check_points/model_3.ckpt")


BF16 = ["model.dtype=bfloat16", "run_suffix=-bf16", "training.max_iteration=1",
        "training.visualize_every=0",
        "model.encoder_kwargs.unet_kwargs.fused_convs=true",
        "model.encoder2_kwargs.fused_convs=true",
        "model.decoder_pixel_kwargs.fused_head=true"]


def _tree_of(path):
    """{key path: (shape, dtype)} of the arrays of a checkpoint file's
    pytrees (the model's and the optimizer's, each a msgpack blob)."""
    from tomosar2height_tpu_torch.train.checkpoint import unpack

    with open(path, "rb") as f:
        tree = {k: unpack(v) for k, v in unpack(f.read())["pytrees"].items()}
    out = {}

    def walk(v, key):
        items = v.items() if isinstance(v, dict) else (
            enumerate(v) if isinstance(v, list) else ())
        for k, x in items:
            walk(x, key + (k,))
        if isinstance(v, np.ndarray):
            out[key] = (v.shape, str(v.dtype))
    walk(tree, ())
    return out


def test_bf16_trains_and_tests_through_the_cli(trained):
    """model.dtype=bfloat16 on the unsorted point path with the conv kernels'
    flags: cli.train writes a checkpoint of the f32 run's arrays (float32
    parameters and optimizer state), cli.test serves it to finite heights."""
    root, ov, out = trained
    bf = cli_train.run(ov + BF16)
    assert bf["n_iter"] == 1 and np.isfinite(bf["windows"][0]["loss"])
    tree = _tree_of(f"{run_dir(root, '-bf16')}/check_points/model_1.ckpt")
    assert tree == _tree_of(f"{run_dir(root)}/check_points/model_1.ckpt")
    assert len(tree) > 100 and {d for k, (_, d) in tree.items() if k[0] == "model"} == {
        "float32"}
    res = cli_test.run(ov + BF16[:2])
    dsm = RasterReader(res["dsm_path"]).get_data()
    assert np.isfinite(dsm).any() and res["stats"]["overall"]["RMSE"] is not None


def test_bf16_on_the_sorted_layout_refused(trained):
    """bf16 on ``sorted_impl=fused`` is no longer refused: cli.train trains
    one iteration (K9, K10, K12 and their backwards at their bf16
    instances on a card) and writes the f32 run's checkpoint arrays, and
    cli.test serves it to finite heights."""
    root, ov, out = trained
    fused = [o.replace("=fused2", "=fused") for o in KERNEL_PATH]
    bf = cli_train.run(ov + fused + ["model.dtype=bfloat16", "run_suffix=-bf16s",
                                     "training.max_iteration=1", "training.visualize_every=0"])
    assert bf["n_iter"] == 1 and np.isfinite(bf["windows"][0]["loss"])
    tree = _tree_of(f"{run_dir(root, '-bf16s')}/check_points/model_1.ckpt")
    assert tree == _tree_of(f"{run_dir(root)}/check_points/model_1.ckpt")
    res = cli_test.run(ov + fused + ["model.dtype=bfloat16", "run_suffix=-bf16s"])
    dsm = RasterReader(res["dsm_path"]).get_data()
    assert np.isfinite(dsm).any() and res["stats"]["overall"]["RMSE"] is not None


def test_bf16_on_fused2_trains_and_tests_through_the_cli(trained):
    """model.dtype=bfloat16 on the kernel path (fused2, K1-K7): cli.train
    writes the f32 run's checkpoint arrays, cli.test serves it to finite
    heights."""
    root, ov, out = trained
    bf = cli_train.run(ov + KERNEL_PATH + BF16[:4] + ["run_suffix=-bf16f2"])
    assert bf["n_iter"] == 1 and np.isfinite(bf["windows"][0]["loss"])
    tree = _tree_of(f"{run_dir(root, '-bf16f2')}/check_points/model_1.ckpt")
    assert tree == _tree_of(f"{run_dir(root)}/check_points/model_1.ckpt")
    res = cli_test.run(ov + KERNEL_PATH + ["model.dtype=bfloat16", "run_suffix=-bf16f2"])
    dsm = RasterReader(res["dsm_path"]).get_data()
    assert np.isfinite(dsm).any() and res["stats"]["overall"]["RMSE"] is not None
