"""The port's ``DSMEvaluator`` and ``print_statistics`` against the JAX
package's: the same GT, mask and target rasters (written by the port, read
by each package's reader), the statistics per mask within 1e-12 (relative;
both compute in the same numpy order, so they come out equal), the residual
raster equal with its NaN mask, and the report's text equal but for its
time stamp."""

from __future__ import annotations

import numpy as np
import pytest

from tomosar2height_tpu.geo.transform import Affine as JaxAffine
from tomosar2height_tpu.infer import DSMEvaluator as JaxEvaluator
from tomosar2height_tpu.infer import print_statistics as jax_print_statistics
from tomosar2height_tpu_torch.geo import Affine, RasterData, RasterReader
from tomosar2height_tpu_torch.infer import DSMEvaluator, print_statistics

X0, Y0, W, H = 1000.0, 5000000.0, 96, 80


@pytest.fixture(scope="module")
def rasters(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluator")
    rng = np.random.default_rng(5)
    gt = np.zeros((H, W), np.float32)
    btype = np.zeros((H, W), np.float32)
    for _ in range(9):
        r, c = rng.integers(2, H - 20), rng.integers(2, W - 20)
        h = rng.uniform(4, 50)
        gt[r:r + 15, c:c + 15] = h
        btype[r:r + 15, c:c + 15] = 1 if h < 25 else 2
    paths = {}
    for name, data in (("gt", gt), ("building", (btype > 0).astype(np.float32)),
                       ("type", btype), ("water", (rng.random((H, W)) > 0.8).astype(np.float32))):
        raster = RasterData([X0, Y0], [X0 + W, Y0 + H], [1.0, 1.0], 25832)
        raster.set_data(data)
        paths[name] = str(root / f"{name}.tif")
        raster.write_to_file(paths[name])
    # a generated nDSM over a window of the scene: 12 m east, 8 m south of
    # its north-west corner, with NaN where no tile reached
    target = np.maximum(gt[8:8 + 56, 12:12 + 64] + rng.normal(0, 2, (56, 64)), 0)
    target[:5, :9] = np.nan
    t = Affine(1.0, 0.0, X0 + 12, 0.0, -1.0, Y0 + H - 8)
    return paths, target.astype(np.float32), t


MASKS = {
    "none": lambda p: None,
    "building": lambda p: {"building": p["building"]},
    "ternary": lambda p: {"building": p["building"], "type": p["type"]},
    "other": lambda p: {"building": p["building"], "type": p["type"], "water": p["water"]},
}


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if b[k] is None or isinstance(b[k], int):
            assert a[k] == b[k], k
        else:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=0), k


@pytest.mark.parametrize("masks", list(MASKS))
@pytest.mark.parametrize("empty", [False, True])
def test_eval_and_report_match_jax(rasters, masks, empty):
    paths, target, t = rasters
    if empty:
        target = np.full_like(target, np.nan)
    mine = DSMEvaluator(paths["gt"], None, MASKS[masks](paths))
    ref = JaxEvaluator(paths["gt"], None, MASKS[masks](paths))
    got, diff = mine.eval(target, t)
    want, ref_diff = ref.eval(target, JaxAffine(*t.coefficients()))
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key])
    assert got["overall"]["n_pixel"] == (None if empty else int((~np.isnan(target)).sum()))
    np.testing.assert_array_equal(diff, ref_diff)
    assert (mine.has_binary_building, mine.has_ternary_building) == (
        ref.has_binary_building, ref.has_ternary_building)
    text = print_statistics(got, "run-iter3", has_binary=mine.has_binary_building,
                            has_ternary=mine.has_ternary_building)
    ref_text = jax_print_statistics(want, "run-iter3", has_binary=ref.has_binary_building,
                                    has_ternary=ref.has_ternary_building)
    assert text.splitlines()[1:] == ref_text.splitlines()[1:]
    assert text.startswith("DSM Evaluation\t\t\tcreated: ")


def test_masks_match_jax(rasters):
    paths, _, _ = rasters
    mine = DSMEvaluator(paths["gt"], paths["building"], MASKS["other"](paths))
    ref = JaxEvaluator(paths["gt"], paths["building"], MASKS["other"](paths))
    assert mine.other_mask.keys() == ref.other_mask.keys() == {
        "building", "terrain", "non_building", "residential", "non_residential",
        "building_combined", "water"}
    for k in ref.other_mask:
        np.testing.assert_array_equal(mine.other_mask[k], ref.other_mask[k])
    np.testing.assert_array_equal(mine.gt_mask, ref.gt_mask)


def test_report_file_and_float64_recomputation(rasters, tmp_path):
    """The report written to a file, and the statistics against a float64
    recomputation from the two rasters (the f32 sums agree within 1e-6)."""
    paths, target, t = rasters
    ev = DSMEvaluator(paths["gt"], None, {"building": paths["building"]})
    stats, _ = ev.eval(target, t)
    out = tmp_path / "eval.txt"
    text = print_statistics(stats, "x", save_to=str(out), has_binary=True)
    assert out.read_text() == text and "Building" in text and "Terrain" in text
    gt = RasterReader(paths["gt"]).get_data().astype(np.float64)[8:64, 12:76]
    r = target.astype(np.float64) - gt
    r = r[~np.isnan(r)]
    assert stats["overall"]["n_pixel"] == r.size
    assert stats["overall"]["RMSE"] == pytest.approx(np.sqrt(np.mean(r ** 2)), rel=1e-6)
    assert stats["overall"]["MAE"] == pytest.approx(np.mean(np.abs(r)), rel=1e-6)
    med = np.median(r)
    assert stats["overall"]["NMAD"] == pytest.approx(1.4826 * np.median(np.abs(r - med)),
                                                     rel=1e-6)
