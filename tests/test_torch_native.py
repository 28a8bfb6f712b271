"""The port's C++ host runtime (``tomosar2height_tpu_torch/csrc/host_runtime.cpp``)
on the CPU: built here with g++ and run, never skipped.

- Every entry point bit-equal to its numpy plain version
  (``tomosar2height_tpu_torch.native.plain``) on the cases of
  ``tests/test_native.py``: the strict crop boundary, the transform (affine
  and projective) and the fused crop-transform with points on the recrop
  edges and a normalized range other than [0, 1], LAS with its error codes,
  ``bucket_points``, ``max_z_grid``, the single and batched blends (1 and 4
  threads; overlap, origins out of range, invalid entries) and
  ``morton_align`` at the JAX test's five shapes, at 256-cell tiles and on
  the u16 wire's dequantized points; the call sites too (the dataset's
  patches and the loader's batches on both routes).
- The plain versions against the JAX package's numpy oracles (its C++ off:
  its availability swings) within the JAX tests' tolerances.
- Two processes that build at once both load a whole library; a build that
  fails raises.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tomosar2height_tpu import native as jnative  # noqa: E402
from tomosar2height_tpu.geo.cloud import load_las_as_numpy as jax_las  # noqa: E402
from tomosar2height_tpu.geo.crop import crop_pc_2d_index as jax_crop_index  # noqa: E402
from tomosar2height_tpu.geo.transform import apply_transform as jax_apply  # noqa: E402
from tomosar2height_tpu.ops import sorted_scatter as jss  # noqa: E402
from tomosar2height_tpu_torch import native  # noqa: E402
from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset  # noqa: E402
from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city  # noqa: E402
from tomosar2height_tpu_torch.geo import ROT_MATRICES, FLIP_MATRICES, save_las  # noqa: E402
from tomosar2height_tpu_torch.native import plain  # noqa: E402
from tomosar2height_tpu_torch.ops import sorted_scatter as ss  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_numpy(monkeypatch):
    """The JAX package on its numpy paths: its C++ runtime is no oracle."""
    for name in ("crop_pc_2d_index", "crop_transform_patch", "las_read", "morton_align",
                 "transform_points_f32", "bucket_points", "max_z_grid"):
        monkeypatch.setattr(jnative, name, lambda *a, **k: None)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
    assert np.array_equal(a, b, equal_nan=True)
    assert a.tobytes() == b.tobytes()


class TestCrop:
    def test_matches_plain_and_jax(self, rng):
        pts = rng.uniform(0, 100, (60000, 4))
        got = native.crop_pc_2d_index(pts, [20, 30], [70, 80])
        _same(got, plain.crop_pc_2d_index(pts, [20, 30], [70, 80]))
        _same(got, jax_crop_index(pts, [20, 30], [70, 80]))

    def test_strict_boundary(self):
        pts = np.array([[0.0, 5.0, 0], [10.0, 5.0, 0], [5.0, 5.0, 0], [5.0, 10.0, 0],
                        [np.nextafter(10.0, 0), np.nextafter(0.0, 1), 0]])
        got = native.crop_pc_2d_index(pts, [0, 0], [10, 10])
        assert got.tolist() == [2, 4]
        _same(got, plain.crop_pc_2d_index(pts, [0, 0], [10, 10]))

    def test_refuses_float32(self):
        with pytest.raises(TypeError):
            native.crop_pc_2d_index(np.zeros((4, 3), np.float32), [0, 0], [1, 1])

    def test_crop_pc_2d_routes(self, rng):
        """``geo.crop_pc_2d``: float64 through the runtime, float32 compared
        in numpy, each as the numpy route gives it."""
        from tomosar2height_tpu_torch.geo import crop_pc_2d

        for dt in (np.float64, np.float32):
            pts = rng.uniform(0, 1, (5000, 3)).astype(dt)
            native.reset_calls()
            got, idx = crop_pc_2d(pts, [0.1, 0.3], [0.7, 0.9])
            want, widx = crop_pc_2d(pts, [0.1, 0.3], [0.7, 0.9], native=False)
            _same(idx, widx)
            _same(got, want)
            assert native.CALLS["crop_pc_2d"] == (dt == np.float64)


def _normalize_mat(rng, lo, hi, rot=0, flip=-1, span=(0.0, 1.0)):
    """World [lo, hi] x z to [span]^2 x [0, 1], after a rotation and a flip as
    the dataset composes them."""
    size = np.asarray(hi, np.float64) - np.asarray(lo, np.float64)
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = (span[1] - span[0]) / size[0], (span[1] - span[0]) / size[1], 0.02
    m[0, 3] = -(lo[0] + size[0] / 2) * m[0, 0]
    m[1, 3] = -(lo[1] + size[1] / 2) * m[1, 1]
    shift = np.eye(4)
    shift[:2, 3] = (span[0] + span[1]) / 2
    return shift @ FLIP_MATRICES[flip] @ ROT_MATRICES[rot] @ m


class TestTransform:
    @pytest.mark.parametrize("projective", [False, True])
    def test_matches_plain_and_jax(self, rng, projective):
        pts = rng.uniform(-10, 10, (3000, 3))
        m = np.eye(4)
        m[:3, :3] = rng.normal(size=(3, 3))
        m[:3, 3] = rng.normal(size=3)
        if projective:
            m[3] = [0.01, -0.02, 0.015, 1.5]
        got = native.transform_points_f32(pts, m)
        _same(got, plain.transform_points_f32(pts, m))
        np.testing.assert_allclose(got, jax_apply(pts, m).astype(np.float32), rtol=1e-6)

    @pytest.mark.parametrize("rot,flip,span", [(0, -1, (0.0, 1.0)), (1, 0, (0.0, 1.0)),
                                               (3, 1, (-0.5, 0.5)), (2, -1, (0.1, 0.7))])
    def test_fused_crop_transform(self, rng, rot, flip, span):
        lo, hi = [20.0, 30.0], [70.0, 80.0]
        m = _normalize_mat(rng, lo, hi, rot, flip, span)
        pts = rng.uniform(0, 100, (30000, 3))
        # points whose normalized x or y lands on a recrop edge or a float32
        # step from it, and points on the world box's edges
        inv = np.linalg.inv(m)
        edge = []
        for v in (span[0], span[1]):
            for d in (-1, 0, 1):
                t = float(np.float32(v)) + d * float(np.spacing(np.float32(v)))
                for a in rng.uniform(span[0], span[1], 4):
                    edge.append((inv @ [t, a, 0.5, 1.0])[:3])
                    edge.append((inv @ [a, t, 0.5, 1.0])[:3])
        edge += [[20.0, 50.0, 1.0], [70.0, 50.0, 1.0], [40.0, 30.0, 1.0], [40.0, 80.0, 1.0]]
        pts = np.concatenate([pts, np.asarray(edge)])
        norm_lo, norm_hi = [span[0], span[0]], [span[1], span[1]]
        got = native.crop_transform_patch(pts, lo, hi, m, norm_lo, norm_hi)
        _same(got, plain.crop_transform_patch(pts, lo, hi, m, norm_lo, norm_hi))
        assert 0 < len(got) < len(pts)
        # the JAX dataset's numpy normalize: world crop, apply_transform, cast,
        # crop at the normalized range (dataset.py:231-243)
        sel = pts[jax_crop_index(pts, lo, hi)]
        t = jax_apply(sel, m).astype(np.float32)
        want = t[jax_crop_index(t, norm_lo, norm_hi)]
        assert want.shape == got.shape
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestLas:
    def test_matches_plain_and_jax(self, tmp_path, rng):
        pts = rng.uniform([384590, 5819040, 30], [385102, 5819552, 80], (5000, 3))
        p = str(tmp_path / "c.las")
        save_las(p, pts)
        got = native.las_read(p)
        _same(got, plain.las_read(p))
        _same(got, jax_las(p))
        np.testing.assert_allclose(got, pts, atol=1e-3)

    def test_las14_extended_count(self, tmp_path, rng):
        pts = rng.uniform(0, 100, (300, 3))
        p = str(tmp_path / "c14.las")
        save_las(p, pts)
        raw = open(p, "rb").read()
        head = bytearray(raw[:227] + bytes(148))  # the 1.4 header is 375 bytes
        head[25] = 4  # LAS 1.4: the legacy count 0, the extended one at 247
        head[94:96] = (375).to_bytes(2, "little")
        head[96:100] = (375).to_bytes(4, "little")
        head[107:111] = (0).to_bytes(4, "little")
        head[247:255] = (300).to_bytes(8, "little")
        open(p, "wb").write(bytes(head) + raw[227:])
        got = native.las_read(p)
        _same(got, plain.las_read(p))
        np.testing.assert_allclose(got, pts, atol=1e-3)

    @pytest.mark.parametrize("case,code", [("missing", -1), ("junk", -2), ("laz", -3),
                                           ("truncated", -4), ("version", -5)])
    def test_error_codes(self, tmp_path, rng, case, code):
        p = str(tmp_path / f"{case}.las")
        if case != "missing":
            save_las(p, rng.uniform(0, 10, (50, 3)))
            raw = bytearray(open(p, "rb").read())
            if case == "junk":
                raw = bytearray(b"NOPE" * 100)
            elif case == "laz":
                raw[104] = 131
            elif case == "truncated":
                raw = raw[:-7]
            elif case == "version":
                raw[24] = 2
            open(p, "wb").write(bytes(raw))
        buf = np.empty((50, 3))
        assert native.library().t2h_las_read(os.fsencode(p), buf.ctypes.data) == code
        with pytest.raises(ValueError, match=native.LAS_ERRORS[code].split(" (")[0]):
            native.las_read(p)
        with pytest.raises((ValueError, OSError)):
            plain.las_read(p)


def test_bucket_points(rng):
    from tomosar2height_tpu.ops.scatter import cell_index

    pts = rng.uniform(-0.05, 1.05, (10000, 3)).astype(np.float32)
    cells, order = native.bucket_points(pts, 64)
    pc, po = plain.bucket_points(pts, 64)
    _same(cells, pc)
    _same(order, po)
    want = np.asarray(cell_index(jax.numpy.asarray(pts[None, :, :2]), 64))[0]
    np.testing.assert_array_equal(cells, want)
    assert (np.diff(cells[order]) >= 0).all()


def test_max_z_grid(rng):
    from tomosar2height_tpu.infer.baselines import max_z_per_pixel

    pts = rng.uniform([-2, -2, 0], [34, 18, 50], (5000, 3))
    grid = native.max_z_grid(pts, [0, 0], [32, 16], [1, 1])
    _same(grid, plain.max_z_grid(pts, [0, 0], [32, 16], [1, 1]))
    assert grid.shape == (16, 32)
    xy, z = max_z_per_pixel(pts, [0, 0], [32, 16], [1, 1])
    cols = np.floor(xy[:, 0]).astype(int)
    rows = np.floor(16 - xy[:, 1]).astype(int)
    np.testing.assert_allclose(grid[rows, cols], z, rtol=1e-6)
    assert np.isfinite(grid).sum() == len(z)


class TestBlend:
    def test_single_matches_plain(self, rng):
        H, W, ph, pw = 64, 64, 16, 16
        acc = [np.zeros((H, W)) for _ in range(6)]
        for _ in range(6):
            patch = rng.normal(size=(ph, pw))
            w = rng.uniform(0.1, 1, (ph, pw))
            r0, c0 = int(rng.integers(-20, H + 4)), int(rng.integers(-20, W + 4))
            native.blend_accumulate(acc[0], acc[1], patch, w, r0, c0)
            plain.blend_accumulate(acc[2], acc[3], patch, w, r0, c0)
            # tests/test_native.py's clipped numpy oracle
            rs = slice(max(r0, 0), min(r0 + ph, H))
            cs = slice(max(c0, 0), min(c0 + pw, W))
            if rs.start < rs.stop and cs.start < cs.stop:
                prs = slice(rs.start - r0, rs.stop - r0)
                pcs = slice(cs.start - c0, cs.stop - c0)
                acc[4][rs, cs] += patch[prs, pcs] * w[prs, pcs]
                acc[5][rs, cs] += w[prs, pcs]
        _same(acc[0], acc[2])
        _same(acc[1], acc[3])
        np.testing.assert_allclose(acc[2], acc[4], atol=1e-12)
        np.testing.assert_allclose(acc[3], acc[5], atol=1e-12)

    @pytest.mark.parametrize("nthreads", [1, 4])
    def test_batch_matches_per_patch(self, rng, nthreads):
        H, W, ph, pw, B = 48, 80, 16, 16, 9
        patches = rng.normal(size=(B, ph, pw))
        w = rng.uniform(0.1, 1, (ph, pw))
        rows0 = rng.integers(-4, H - 8, B)
        cols0 = rng.integers(-4, W - 8, B)
        rows0[2] = rows0[3]  # overlap
        cols0[3] = cols0[2] + 4
        rows0[6], cols0[6] = -ph - 3, 5  # wholly outside
        rows0[7], cols0[7] = H - 2, W - 3
        valid = np.ones(B, bool)
        valid[5] = False
        acc = [np.zeros((H, W)) for _ in range(6)]
        native.blend_accumulate_batch(acc[0], acc[1], patches, w, rows0, cols0, valid,
                                      nthreads)
        plain.blend_accumulate_batch(acc[2], acc[3], patches, w, rows0, cols0, valid)
        for i in np.nonzero(valid)[0]:
            native.blend_accumulate(acc[4], acc[5], patches[i], w, rows0[i], cols0[i])
        for a, b in ((0, 2), (1, 3), (0, 4), (1, 5)):
            _same(acc[a], acc[b])
        assert acc[1].max() > 1.0  # the overlap added twice


# tests/test_native.py's five shapes, then 256-cell tiles on the u16 wire
MORTON_CASES = [(16384, 256, 1024, 1.0, False), (16384, 256, 256, 0.7, False),
                (5000, 128, 1024, 0.9, False), (100, 256, 1024, 0.0, False),
                (8192, 256, 1024, 0.5, False), (9000, 256, 256, 0.8, True)]


@pytest.mark.parametrize("n,reso,tile_cells,frac,u16", MORTON_CASES)
def test_morton_align(rng, n, reso, tile_cells, frac, u16):
    pts = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    if u16:
        pts = ss.dequantize_points_np(ss.quantize_points_u16(pts))
    mask = rng.uniform(size=n) < frac
    npad = ss.aligned_bucket_size(n, reso, ss.PCHUNK, tile_cells)
    got = native.morton_align(pts, mask, reso, ss.PCHUNK, tile_cells, npad,
                              int(ss.PAD_CELL_SENTINEL))
    ref = plain.morton_align(pts, mask, reso, ss.PCHUNK, tile_cells)
    want = jss.host_morton_bucket_aligned(pts, mask, reso, ss.PCHUNK, tile_cells)
    for k in ("points", "mask", "cells", "tile_offsets"):
        _same(got[k], ref[k])
        _same(ref[k], np.asarray(want[k]))
    # the loader's call: the valid points alone, no mask, into given arrays
    out = (np.empty((npad, 3), np.float32), np.empty(npad, bool), np.empty(npad, np.int32),
           np.empty(reso * reso // tile_cells + 1, np.int32))
    alone = native.morton_align(pts[mask], None, reso, ss.PCHUNK, tile_cells, npad,
                                int(ss.PAD_CELL_SENTINEL), out=out)
    for k in ("points", "mask", "cells", "tile_offsets"):
        _same(alone[k], ref[k])
    if mask.sum() > ss.PCHUNK:  # the layout overflows one chunk's rows
        with pytest.raises(ValueError, match="passes"):
            native.morton_align(pts, mask, reso, ss.PCHUNK, tile_cells, ss.PCHUNK,
                                int(ss.PAD_CELL_SENTINEL))


# -- the call sites ---------------------------------------------------------------

CFG = {"patch_size": [128.0, 128.0], "sliding_window": {"test_strip": [96.0, 96.0]},
       "normalize": {"x_range": [-0.5, 0.3], "y_range": [-0.5, 0.3], "z_bound": [-10.0, 90.0],
                     "z_shift": "local_min"}}


@pytest.fixture(scope="module")
def scene():
    _, pts, _ = build_city(1, density=0.2, W=384, H=288)
    return [{"name": "c", "min_bound": [X0, Y0], "max_bound": [X0 + 384, Y0 + 288],
             "points": pts}]


@pytest.mark.parametrize("random_sample", [False, True])
def test_scene_patches_both_routes(scene, random_sample):
    """Crops and normalize on both routes, with augmentation and a
    normalized range other than [0, 1]."""
    kw = dict(random_sample=random_sample, random_length=12, flip_augm=random_sample,
              rotate_augm=random_sample)
    a = SceneDataset(scene, CFG, "test", native=True, **kw)
    b = SceneDataset(scene, CFG, "test", native=False, **kw)
    assert len(a) == len(b) >= 9
    native.reset_calls()
    for i in range(len(a)):
        pa = a.__getitem__(i, np.random.default_rng(i))
        pb = b.__getitem__(i, np.random.default_rng(i))
        assert pa.keys() == pb.keys()
        for k in pa:
            if isinstance(pa[k], np.ndarray):
                _same(pa[k], pb[k])
            else:
                assert pa[k] == pb[k], k
    assert native.CALLS["crop_transform_patch"] == len(a)
    assert native.CALLS["crop_pc_2d"] == len(a)


@pytest.mark.parametrize("wire,bucket", [("float32", 2048), ("uint16", 1024)])
def test_loader_batches_both_routes(scene, wire, bucket):
    """Aligned batches on both routes: 256-cell tiles, subsampled patches
    past a small bucket, the u16 wire."""
    def batches(nat):
        ds = SceneDataset(scene, CFG, "test", native=nat)
        return list(PatchLoader(ds, 3, [bucket], fixed_bucket=bucket, sort_reso=64,
                                tile_cells=256, wire_points=wire, native=nat))

    native.reset_calls()
    a = batches(True)
    assert native.CALLS["morton_align"] > 0
    b = batches(False)
    assert len(a) == len(b) >= 3
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if k != "name":
                _same(np.asarray(x[k]), np.asarray(y[k]))


def test_threads_share_the_runtime():
    """More threads than cores call the runtime at once, the interpreter
    switching threads often: each result right, no call count lost."""
    import threading

    pts = np.random.default_rng(5).uniform(0, 10, (2000, 3))
    want = plain.crop_pc_2d_index(pts, [2, 3], [7, 8])
    n_threads, n_calls = 2 * (os.cpu_count() or 1) + 3, 40
    bad = []

    def work():
        for _ in range(n_calls):
            if not np.array_equal(native.crop_pc_2d_index(pts, [2, 3], [7, 8]), want):
                bad.append(1)

    switch = sys.getswitchinterval()
    native.reset_calls()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert native.CALLS["crop_pc_2d"] == n_threads * n_calls


def test_morton_align_refuses_bad_grids():
    pts = np.zeros((4, 3), np.float32)
    for reso, tile in ((48, 256), (64, 3000)):
        with pytest.raises(ValueError, match="power of two"):
            native.morton_align(pts, None, reso, ss.PCHUNK, tile, 4096,
                                int(ss.PAD_CELL_SENTINEL))


# -- the build ----------------------------------------------------------------------

def test_two_builds_at_once(tmp_path):
    """Two processes build into one empty directory at once: each loads a
    whole library and calls it; no partial file is left."""
    code = ("import sys, numpy as np\n"
            "from tomosar2height_tpu_torch import native\n"
            "path, built, _ = native.build(native.SOURCE, sys.argv[1])\n"
            "lib = native.load(path)\n"
            "print(lib.t2h_host_runtime_version().decode(), built)\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("t2h host runtime")
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".so"), files


def test_failed_build_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int t2h_nothing() { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match="undefined_name"):
        native.build(str(src), str(tmp_path / "build"))
    assert not os.listdir(tmp_path / "build")
