"""The port's on-device blend (``DSMGenerator(device_blend=True)``) on the CPU,
on the tiny city and model of tests/test_torch_generator.py:

- against the port's host blend within the JAX package's bounds
  (``tests/test_sharded_infer.py:115-145``: atol 2e-3 + rtol 1e-4; the f16
  wire + scale * 2^-10), NaN masks equal; bit-equal run to run;
- against the JAX package's device blend on the same weights (JAX on its
  plain path, the port on fused2) within the model's 2e-4 * z_scale plus
  the blend's bound, in f32 and, with JAX's f16 bound, on the f16 wire;
- ``blend_loop='scan'`` bit-equal to ``'unroll'``;
- fixed tile rasters with origins over the scene's edges, bit-equal to a
  numpy float32 emulation of JAX's clamped read-modify-write
  (``_blend_step_impl``), on both loops;
- the band plan's last-touch invariant (``tests/test_sharded_infer.py:313-356``);
- the host blend on the C++ route bit-equal to its numpy plain version;
- a mesh above one still refused.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from test_torch_generator import BUCKET, _overrides, _sorted_cfg  # noqa: E402
from tomosar2height_tpu.config import compose  # noqa: E402
from tomosar2height_tpu.config.compose import default_conf_dir  # noqa: E402
from tomosar2height_tpu.data import PatchLoader as JaxPatchLoader  # noqa: E402
from tomosar2height_tpu.data import TomoSARDataset, build_dataset  # noqa: E402
from tomosar2height_tpu.geo import RasterReader  # noqa: E402
from tomosar2height_tpu_torch.config import select_device  # noqa: E402
from tomosar2height_tpu_torch.geo import RasterData  # noqa: E402
from tomosar2height_tpu_torch.infer.generator import make_generator  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import load_flax_params  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    import make_synthetic_city as msc

    root = str(tmp_path_factory.mktemp("torch_blend"))
    msc.main(root, seed=0, density=0.15)
    cfg = compose(default_conf_dir(), overrides=_overrides(root))
    build_dataset(cfg, overwrite=True)
    ds = TomoSARDataset("test", cfg["dataset"], random_sample=False,
                        load_target=False, load_image=False)
    chunks = [{"name": ds.chunk_info[i]["name"], "min_bound": ds.chunk_info[i]["min_bound"],
               "max_bound": ds.chunk_info[i]["max_bound"], "points": ds.data_dic[i]["inputs"]}
              for i in ds.dataset_chunk_idx_ls]
    return root, cfg, ds, chunks


@pytest.fixture(scope="module")
def jax_side(city, tmp_path_factory):
    """The JAX generator's device-blend raster on its plain path, and its
    flax parameters."""
    import jax.numpy as jnp

    from tomosar2height_tpu.infer import DSMGenerator as JaxDSMGenerator
    from tomosar2height_tpu.models import build_model as jax_build_model

    _, cfg, ds, _ = city
    jloader = JaxPatchLoader(ds, 2, [BUCKET], fixed_bucket=BUCKET)
    jmodel = jax_build_model(cfg)
    sample = jloader.collate([ds[0]])
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(sample["points"]),
                                  jnp.asarray(sample["point_mask"]))
    dsm = cfg["dsm_generation"]
    jgen = JaxDSMGenerator(jmodel, lambda: params, jloader, dsm["pixel_size"],
                           half_blend_percent=dsm.get("half_blend_percent"),
                           crs_epsg=dsm.get("crs_epsg"), use_cloud=True,
                           use_image=False, device_blend=True)
    path = str(tmp_path_factory.mktemp("jax_blend") / "jax.tif")
    jgen.generate_dsm(path)
    return RasterReader(path).get_data(), jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port(city, jax_side, tmp_path_factory):
    """The port's fused2 model on the JAX weights and a generator factory;
    the host blend's raster (f32 wire)."""
    _, cfg, _, chunks = city
    pcfg = _sorted_cfg(cfg)
    model = load_flax_params(build_model(pcfg, device="cpu"), jax_side[1]).eval()
    tmp = tmp_path_factory.mktemp("port_blend")

    done = {}

    def run(tag, generate=True, **kw):
        """(raster, generator) of a generator with ``kw``; ``tag`` names a
        run, which the module's tests share."""
        if tag not in done:
            gen = make_generator(model, pcfg, chunks, **kw)
            data = None
            if generate:
                data = gen.generate_dsm(str(tmp / f"{tag}.tif")).data
                np.testing.assert_array_equal(RasterReader(str(tmp / f"{tag}.tif")).get_data(),
                                              data)
            done[tag] = data, gen
        return done[tag]

    host, _ = run("host")
    return run, host, pcfg


def _within(got, ref, atol, rtol=0.0):
    nan = np.isnan(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan.any() and not nan.all()
    np.testing.assert_allclose(got[~nan], ref[~nan], atol=atol, rtol=rtol)
    assert (got[~nan] >= 0).all()


def _scale(ref):
    return max(1.0, float(np.nanmax(np.abs(ref))))


def test_device_blend_matches_host_blend(port):
    run, host, _ = port
    dev, gen = run("dev", device_blend=True)
    assert gen.last_stats["n_patches"] == 9 and gen.last_stats["blend_cpu_s"] == 0.0
    for k in ("drain_s", "fetch_wait_s", "device_wait_blend_s", "fetch_thread_s"):
        assert k in gen.last_stats
    _within(dev, host, atol=2e-3, rtol=1e-4)
    again, _ = run("dev2", device_blend=True)
    np.testing.assert_array_equal(again, dev)


def test_device_blend_f16_wire(port):
    run, host, _ = port
    dev, _ = run("dev16", device_blend=True, wire_dtype="float16")
    _within(dev, host, atol=2e-3 + _scale(host) * 2.0 ** -10)
    assert dev.dtype == np.float32


def test_scan_bit_equal_to_unroll(port):
    run, _, _ = port
    unroll, _ = run("dev", device_blend=True)
    scan, _ = run("scan", device_blend=True, blend_loop="scan")
    np.testing.assert_array_equal(scan, unroll)


@pytest.mark.parametrize("wire", ["float32", "float16"])
def test_device_blend_matches_jax_device_blend(city, jax_side, port, wire):
    _, cfg, _, _ = city
    run, _, _ = port
    ref = jax_side[0]
    dev, _ = run("dev16" if wire == "float16" else "dev", device_blend=True, wire_dtype=wire)
    z = cfg["dataset"]["normalize"]["z_bound"]
    # JAX's f16 rule: the f16 rounding of the stitched raster, <= 2^-11 of
    # the heights, beside the f32 raster (tests/test_sharded_infer.py:137-145)
    r16 = _scale(ref) * 2.0 ** -10 if wire == "float16" else 0.0
    _within(dev, ref, atol=2e-4 * (z[1] - z[0]) + 2e-3 + r16, rtol=1e-4)


def test_host_blend_routes_bit_equal(port):
    run, host, _ = port
    numpy_route, gen = run("numpy", native=False)
    assert not gen.native and not gen.data_loader.native
    np.testing.assert_array_equal(numpy_route, host)


@pytest.mark.parametrize("loop", ["unroll", "scan"])
def test_blend_step_clamps_as_jax(port, loop):
    """Fixed tile rasters, origins over every edge and an invalid entry,
    against numpy float32: each entry's window at its origin clamped into
    the raster gains (h * pw32) * v, its weight pw32 * v, in batch order."""
    run, _, _ = port
    _, gen = run(f"probe{loop}", generate=False, device_blend=True, blend_loop=loop)
    rng = np.random.default_rng(3)
    pw32 = gen.patch_weight.astype(np.float32)
    ph, pwid = pw32.shape
    H, W = 100, 150
    rows0 = np.array([-20, 90, 10, 40, 70, 10, 1000, -5])
    cols0 = np.array([-7, 130, 140, -40, 60, 10, 5, 200])
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    h = rng.normal(10, 5, (len(rows0), ph, pwid)).astype(np.float32)
    dsm = torch.zeros((H, W))
    wgt = torch.zeros((H, W))
    gen._blend_step(dsm, wgt, torch.from_numpy(h), torch.from_numpy(pw32), rows0, cols0,
                    valid)
    d, w = np.zeros((H, W), np.float32), np.zeros((H, W), np.float32)
    for i in range(len(rows0)):
        r = min(max(int(rows0[i]), 0), H - ph)
        c = min(max(int(cols0[i]), 0), W - pwid)
        v = np.float32(valid[i])
        d[r:r + ph, c:c + pwid] = d[r:r + ph, c:c + pwid] + h[i] * pw32 * v
        w[r:r + ph, c:c + pwid] = w[r:r + ph, c:c + pwid] + pw32 * v
    np.testing.assert_array_equal(dsm.numpy(), d)
    np.testing.assert_array_equal(wgt.numpy(), w)
    assert w[:, -1].max() > 0 and w[-1].max() > 0  # the clamp reached the far edges


def test_band_plan_last_touch(city, port):
    """No batch after a band's last-touch index writes rows into it."""
    run, _, _ = port
    _, gen = run("probe", generate=False, device_blend=True)
    tiff = RasterData([gen.l_bound, gen.b_bound], [gen.r_bound, gen.t_bound],
                      gen.pixel_size, gen.crs_epsg)
    plan = gen._band_plan(tiff)
    assert plan is not None
    bands, last = plan
    H = int(gen.dsm_shape[0])
    ph = int(gen.patch_weight.shape[0])
    assert bands[0][0] == 0 and bands[-1][1] == H and len(bands) >= 2
    touched = 0
    for k, batch in enumerate(gen.data_loader):
        rows0, _, valid = gen._patch_origins(tiff, batch)
        for i in np.nonzero(valid)[0]:
            r_eff = min(max(int(rows0[i]), 0), max(H - ph, 0))
            for b, (r0, r1) in enumerate(bands):
                if r_eff < r1 and r_eff + ph > r0:
                    touched += 1
                    assert last[b] >= k, (b, k)
    assert touched > 0


def test_mesh_above_one_refused(port):
    _, _, pcfg = port
    cfg = {**pcfg, "device": {**pcfg["device"], "platform": "cpu",
                              "mesh": {**pcfg["device"]["mesh"], "data": 2}}}
    with pytest.raises(NotImplementedError, match="data parallelism"):
        select_device(cfg)
