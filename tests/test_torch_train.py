"""The port's training slice against the JAX package on the CPU.

- One Trainer mini-step on two batches: the port's per-parameter gradients
  (through the Functions of pool2, scatter_plane2 and the fused level,
  K1-K5's plain versions here, with remat; in float64, see the test) against
  ``jax.grad`` of the JAX ``Trainer._loss`` on the fused2 path (its Pallas
  kernels in interpret mode), same weights through the bridge, at
  2e-4 * max|g| + 2e-4 rel per parameter; the f32 loss at 1e-5. Once more
  on the default f16 target wire on both sides, at the same tolerances.
- A 3-window trajectory (optimize_every 2) of the port ``Trainer`` against
  the JAX ``Trainer``: window losses at 1e-4 rel; the final parameters as
  updates, |p_port - p_jax| / |p_jax - p_0|, at 2e-3 over all parameters
  and 2e-2 for each tensor (measured: 3e-5, 3.9e-4 and 4.0e-3). Elements are
  not compared one by one: Adam moves each by about lr a step whatever its
  gradient's size, so an element whose gradient is at rounding level may go
  either way. A control with targets raised by 1 m must fail all three
  (measured: 2.6e-2, 0.07 and 0.32).
- The schedulers against JAX ``schedule.py``; the training loader
  (random anchors, targets, shuffle, drop_last, det_stream) and validation
  patches against the JAX ``PatchLoader`` + ``TomoSARDataset`` on a tiny
  on-disk synthetic dataset; the loop's iteration bookkeeping, and its
  per-window step times (no CUDA event outlives its window).
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from tomosar2height_tpu.config import compose  # noqa: E402
from tomosar2height_tpu.config.compose import default_conf_dir  # noqa: E402
from tomosar2height_tpu.data import PatchLoader as JaxPatchLoader  # noqa: E402
from tomosar2height_tpu.data import TomoSARDataset, build_dataset  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh, replicate  # noqa: E402
from tomosar2height_tpu.train import schedule as jax_schedule  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu.train.trainer import TrainState  # noqa: E402
from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset  # noqa: E402
from tomosar2height_tpu_torch.geo import RasterData  # noqa: E402
from tomosar2height_tpu_torch.models import build_model  # noqa: E402
from tomosar2height_tpu_torch.ops.sorted_scatter import (  # noqa: E402
    aligned_bucket_size,
    host_morton_bucket_aligned,
)
from tomosar2height_tpu_torch.train import loop as port_loop  # noqa: E402
from tomosar2height_tpu_torch.train import schedule  # noqa: E402
from tomosar2height_tpu_torch.train.trainer import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    load_flax_params,
    state_dict_to_flax,
    flatten_tree,
)

RESO = 32
B = 2
N = 400
OUT = 64  # the decoder's output size
LRS = [1e-3, 2e-3, 3e-3]  # the trajectory's learning rate per window


def train_cfg(sorted_impl: str = "fused2") -> dict:
    """The flagship network cut to CPU size: plane 32, depth 2 (two fused
    level round trips), widths 8, remat on."""
    return {
        "use_cloud": True, "use_image": False,
        "dataset": {"normalize": {"z_bound": [0.0, 60.0]}},
        "model": {
            "encoder": "pointnet_local_pool", "remat": True,
            "encoder_kwargs": {
                "hidden_dim": 8, "feature_dim": 8, "plane_resolution": RESO,
                "scatter_type": "max", "sorted_impl": sorted_impl, "unet_type": "alto",
                "unet_kwargs": {"depth": 2, "merge_mode": "concat", "start_filts": 8}},
            "decoder_pixel_kwargs": {
                "mode": "conv", "use_footprint": False, "hidden_dim": 8, "out_dim": 1,
                "output_size": OUT, "sample_mode": "bilinear", "leaky": False},
        },
    }


def make_batches(seed: int, count: int, valid=None):
    """Aligned fused2 batches with targets, made with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    npad = aligned_bucket_size(N, RESO)
    for _ in range(count):
        pts = np.full((B, npad, 3), 0.5, np.float32)
        mask = np.zeros((B, npad), bool)
        cells = np.zeros((B, npad), np.int32)
        toff = np.zeros((B, RESO * RESO // 1024 + 1), np.int32)
        for i in range(B):
            p = rng.uniform(0.001, 0.999, (N, 3)).astype(np.float32)
            a = host_morton_bucket_aligned(p, rng.random(N) > 0.05, RESO)
            pts[i], mask[i], cells[i], toff[i] = (
                a["points"], a["mask"], a["cells"], a["tile_offsets"])
        out.append({"points": pts, "point_mask": mask, "cell": cells, "cell_offsets": toff,
                    "patch_valid": np.array(valid if valid is not None else [True] * B),
                    "dsm": rng.uniform(0.0, 30.0, (B, OUT, OUT)).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX Trainer (optimize_every 2, f32 wire) and its initial params."""
    model = jax_build_model(train_cfg())
    trainer = JaxTrainer(model, {"optimize_every": 2, "wire_dsm_dtype": "float32"},
                         use_cloud=True, mesh=make_mesh(1), donate=False)
    # the unsorted path declares the same parameters and initializes faster
    b = make_batches(0, 1)[0]
    params = jax_build_model(train_cfg("cumsum")).init(
        jax.random.PRNGKey(0), jnp.asarray(b["points"]), jnp.asarray(b["point_mask"]))
    state = TrainState(params, trainer.tx.init(params), jnp.zeros((), jnp.int32),
                       jnp.zeros((5,), jnp.float32))
    return trainer, replicate(state, trainer.mesh)


def port_trainer(params, optimize_every=2, wire="float32"):
    model = load_flax_params(build_model(train_cfg(), device="cpu"),
                             jax.tree.map(np.asarray, params))
    return Trainer(model, {"optimize_every": optimize_every, "wire_dsm_dtype": wire})


def _assert_tree_close(got: dict, want: dict, rel: float):
    """Per leaf: rel + rel * the leaf's max |value| abs."""
    a, b = flatten_tree(got["params"]), flatten_tree(want["params"])
    assert sorted(a) == sorted(b)
    for k in a:
        w = np.asarray(b[k])
        np.testing.assert_allclose(a[k], w, rtol=rel, atol=rel * float(np.abs(w).max()),
                                   err_msg=str(k))


def _gradients_match_jax(jtrainer, params, batch, wire):
    """One step's loss (f32 at 1e-5) and gradients (the port in float64, at
    2e-4 * max|g| + 2e-4 rel) against the JAX trainer's, both on ``wire``;
    returns the port's trainer."""
    jbatch = jtrainer.prepare_batch(batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtrainer._loss, has_aux=True))(
        params, jbatch)
    trainer = port_trainer(params, wire=wire)
    loss32, _ = trainer.loss(trainer.prepare_batch(batch))
    np.testing.assert_allclose(float(loss32.detach()), float(jloss), rtol=1e-5)
    trainer.model.double()
    dev = trainer.prepare_batch(batch)
    loss, _ = trainer.loss({**dev, "points": dev["points"].double()})
    names = [k for k, _ in trainer.model.named_parameters()]
    grads = torch.autograd.grad(loss, trainer.params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_tree_close(state_dict_to_flax(dict(zip(names, grads))),
                       jax.tree.map(np.asarray, jgrads), 2e-4)
    return trainer


class TestTrainStep:
    @pytest.mark.parametrize("seed", [1, 2])
    def test_gradients_match_jax(self, jax_setup, seed):
        """The port's step runs here in float64, the JAX one in float32.

        A ReLU gate whose pre-activation lies within f32 rounding of 0 opens
        in one f32 run and not in another (measured: one gate of the
        decoder's conv2 at 1.4e-7 against <= 0 in float64), and that one gate
        moves a conv kernel's gradient by ~3e-4 of its largest element. The
        port's f32 gradients are 2.0x and 2.5x this tolerance from its own
        float64 ones on these two batches; the JAX f32 gradients 0.04x and
        0.16x. So float64 on the port side holds the math to the stated
        tolerance; the f32 step is held by the loss here and by the
        trajectory test below."""
        jtrainer, state = jax_setup
        _gradients_match_jax(jtrainer, state.params, make_batches(seed, 1)[0], "float32")

    def test_f16_wire_gradients_match_jax(self, jax_setup):
        """The default wire (``wire_dsm_dtype: float16``) on both sides: the
        target is rounded to f16 before the loss (at these 0-30 m targets by
        up to 2^-7 m; 0.125 m at the top of a 256-512 m range), the same
        rounding in both packages, so the f32 wire's tolerances hold."""
        model = jax_build_model(train_cfg())
        jtrainer = JaxTrainer(model, {"optimize_every": 2, "wire_dsm_dtype": "float16"},
                              use_cloud=True, mesh=make_mesh(1), donate=False)
        batch = make_batches(1, 1)[0]
        trainer = _gradients_match_jax(jtrainer, jax_setup[1].params, batch, "float16")
        dsm = trainer.prepare_batch(batch)["dsm"]
        assert dsm.dtype == torch.float16
        assert not np.array_equal(dsm.float().numpy(), batch["dsm"])  # the wire rounded

    @pytest.fixture(scope="class")
    def trajectory(self, jax_setup):
        """3 windows of 2 mini-steps on both trainers from the same weights;
        the port also runs the control with targets + 1 m."""
        jtrainer, state = jax_setup
        batches = make_batches(2, 6)
        lrs = LRS
        jlosses = []
        for w in range(3):
            for b in batches[2 * w: 2 * w + 2]:
                state = jtrainer.train_step(state, b, lrs[w])
            jlosses.append(jtrainer.last_avg_loss)
        runs = {}
        for name, shift in (("port", 0.0), ("control", 1.0)):
            trainer = port_trainer(jax_setup[1].params)
            losses = []
            for w in range(3):
                for b in batches[2 * w: 2 * w + 2]:
                    trainer.train_step({**b, "dsm": b["dsm"] + np.float32(shift)}, lrs[w])
                losses.append(trainer.last_avg_loss)
            runs[name] = (losses, trainer)
        return jlosses, state, runs

    @staticmethod
    def _check(run, jlosses, params0, state):
        losses, trainer = run
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        sd = {k: v.detach() for k, v in trainer.model.named_parameters()}
        got = flatten_tree(state_dict_to_flax(sd)["params"])
        want = flatten_tree(jax.tree.map(np.asarray, state.params)["params"])
        p0 = flatten_tree(jax.tree.map(np.asarray, params0)["params"])
        err = {k: np.linalg.norm(got[k] - want[k]) for k in want}
        moved = {k: np.linalg.norm(want[k] - p0[k]) for k in want}
        for k in want:
            assert err[k] <= 2e-2 * moved[k], (k, err[k], moved[k])
        total = np.sqrt(sum(e ** 2 for e in err.values()))
        assert total <= 2e-3 * np.sqrt(sum(m ** 2 for m in moved.values()))

    def test_trajectory_matches_jax(self, trajectory, jax_setup):
        jlosses, state, runs = trajectory
        self._check(runs["port"], jlosses, jax_setup[1].params, state)
        assert runs["port"][1].mini_step == 6 and runs["port"][1].accumulated_steps == 0

    def test_perturbed_control_is_rejected(self, trajectory, jax_setup):
        jlosses, state, runs = trajectory
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(runs["control"][0], jlosses, rtol=1e-4)
        with pytest.raises(AssertionError):  # the parameters alone
            self._check((jlosses, runs["control"][1]), jlosses, jax_setup[1].params, state)


class TestTrainerUnits:
    def test_accumulation_masking_and_wire(self):
        torch.manual_seed(0)
        model = build_model(train_cfg(), device="cpu")
        trainer = Trainer(model, {"optimize_every": 2})  # f16 wire by default
        batches = make_batches(3, 2, valid=[True, False])
        p0 = [p.detach().clone() for p in trainer.params]
        trainer.train_step(batches[0], 1e-3)
        assert all(torch.equal(a, b) for a, b in zip(p0, trainer.params))
        assert trainer.last_avg_loss == 0.0  # no window closed yet
        # an invalid patch's target cannot reach the loss, even past f16's range
        poison = dict(batches[1], dsm=batches[1]["dsm"].copy())
        poison["dsm"][1] = 1e9
        dev = trainer.prepare_batch(poison)
        assert dev["dsm"].dtype == torch.float16 and torch.isfinite(dev["dsm"]).all()
        clean = trainer.eval_step(batches[1])
        assert trainer.eval_step(poison) == clean
        trainer.train_step(batches[1], 1e-3)
        assert trainer.accumulated_steps == 0 and trainer.last_avg_loss > 0
        assert not all(torch.equal(a, b) for a, b in zip(p0, trainer.params))
        m = trainer.last_avg_loss_dict
        assert m["grad_norm"] > 0 and m["param_norm"] > 0 and m["loss_ce"] == 0.0

    def test_grad_reduction_sum_scales_the_window(self):
        """'sum' applies k times the mean gradient: with Adam's first step
        (update ~ lr * sign(g)) the step is the same, so compare the
        optimizer's gradient instead."""
        batches = make_batches(4, 2)
        grads = {}
        for red in ("mean", "sum"):
            torch.manual_seed(1)
            trainer = Trainer(build_model(train_cfg(), device="cpu"),
                              {"optimize_every": 2, "grad_reduction": red})
            seen = []
            trainer.optimizer.step = lambda: seen.append(  # noqa: E731
                [p.grad.clone() for p in trainer.params])
            for b in batches:
                trainer.train_step(b, 1e-3)
            grads[red] = seen[0]
        for a, b in zip(grads["mean"], grads["sum"]):
            torch.testing.assert_close(b, 2 * a)

    def test_step_keeps_cudnn_deterministic(self):
        """The step's conv scope asks cuDNN for deterministic algorithms
        (its backward convs run there), full float32 too; a layer's own
        scope inside keeps that; the caller's flags come back after."""
        from tomosar2height_tpu_torch.ops.cuda.conv_kernel import fp32_convs

        cudnn = torch.backends.cudnn
        prev = cudnn.allow_tf32, cudnn.deterministic
        try:
            cudnn.allow_tf32, cudnn.deterministic = True, False
            with fp32_convs(deterministic=True):
                with fp32_convs():
                    assert cudnn.deterministic and not cudnn.allow_tf32
                assert cudnn.deterministic and not cudnn.allow_tf32
            assert cudnn.allow_tf32 and not cudnn.deterministic
            torch.manual_seed(0)
            trainer = Trainer(build_model(train_cfg(), device="cpu"), {"optimize_every": 1})
            seen = []
            loss = trainer.loss
            trainer.loss = lambda b: (seen.append((cudnn.deterministic, cudnn.allow_tf32)),
                                      loss(b))[1]
            trainer.train_step(make_batches(5, 1)[0], 1e-3)
            assert seen == [(True, False)]
            assert cudnn.allow_tf32 and not cudnn.deterministic
        finally:
            cudnn.allow_tf32, cudnn.deterministic = prev


class TestSchedulers:
    CASES = [
        ("CyclicLR", dict(base_lr=1e-4, max_lr=5e-4, step_size_up=5, step_size_down=5,
                          mode="triangular2")),
        ("CyclicLR", dict(base_lr=1e-4, max_lr=5e-4, step_size_up=3, mode="exp_range",
                          gamma=0.9)),
        ("CosineAnnealingLR", dict(base_lr=1e-3, T_max=7, eta_min=1e-5)),
        ("CosineAnnealingWarmRestarts", dict(base_lr=1e-3, T_0=3, T_mult=2)),
        ("ReduceLROnPlateau", dict(base_lr=1e-3, factor=0.5, patience=1)),
    ]

    @pytest.mark.parametrize("name,kwargs", CASES)
    def test_matches_jax(self, name, kwargs):
        mine, ref = schedule.SCHEDULERS[name](**kwargs), jax_schedule.SCHEDULERS[name](**kwargs)
        metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8] * 3
        for i in range(25):
            m = metrics[i] if name == "ReduceLROnPlateau" else None
            assert mine.step(m) == ref.step(m), (name, i)
        assert mine.lr == ref.lr

    def test_build_from_flagship_config(self):
        from tomosar2height_tpu_torch.config import flagship_config

        cfg = flagship_config()["training"]
        mine, ref = schedule.build_scheduler(cfg), jax_schedule.build_scheduler(copy.deepcopy(cfg))
        assert type(mine).__name__ == "CyclicLR"
        for _ in range(1200):
            assert mine.step() == ref.step()


class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


class TestLoop:
    def test_iterations_schedule_and_skips(self):
        torch.manual_seed(0)
        trainer = Trainer(build_model(train_cfg(), device="cpu"), {"optimize_every": 2})
        batches = make_batches(5, 3) + make_batches(6, 1, valid=[False, False])
        cfg = {"scheduler": {"type": "CyclicLR"}, "validate_every": 2, "print_every": 1,
               "model_selection_metric": "loss_l1"}
        sched = schedule.CyclicLR(base_lr=1e-4, max_lr=5e-4, step_size_up=2)
        want_lrs = [sched._compute_lr(i, None) for i in range(3)]  # one step per iteration
        out = port_loop.train(trainer, sched, _ListLoader(batches), cfg,
                              val_loader=_ListLoader(batches[:1]), max_iteration=3)
        assert [w["iteration"] for w in out["windows"]] == [1, 2, 3]
        # 3 valid batches per pass, 2 mini-steps per iteration: 6 mini-steps
        assert out["n_ministeps"] == 6 and out["n_patches"] == 12
        assert [w["lr"] for w in out["windows"]] == want_lrs
        assert [v["iteration"] for v in out["val"]] == [2]
        assert np.isfinite(out["loss_val_best"])
        assert all(np.isfinite(w["loss"]) and w["time_step_s"] > 0 for w in out["windows"])
        assert out["step_ms"] == [] and out["median_step_ms"] is None  # no card here

    def test_step_events_are_read_and_dropped_per_window(self, monkeypatch):
        """On a card every mini-step is bracketed by two CUDA events. They
        are read into the window's record when it closes and then dropped:
        no event outlives its window. A fake trainer on a 'cuda' device and
        fake events (a clock that advances on each record) stand in for the
        card."""

        class FakeEvent:
            live = 0
            clock = 0.0

            def __init__(self, enable_timing=False):
                FakeEvent.live += 1

            def __del__(self):
                FakeEvent.live -= 1

            def record(self):
                FakeEvent.clock += 1.5
                self.t = FakeEvent.clock

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return end.t - self.t

        class FakeTrainer:
            device = torch.device("cuda")
            accumulated_steps = 0
            last_avg_loss = 1.0
            last_avg_loss_dict: dict = {}
            most_live = 0

            def prepare_batch(self, batch):
                return batch

            def train_step(self, batch, lr):
                # this step's two events exist; the open window's earlier ones may
                assert FakeEvent.live <= 2 * (self.accumulated_steps + 1)
                FakeTrainer.most_live = max(FakeTrainer.most_live, FakeEvent.live)
                self.accumulated_steps = (self.accumulated_steps + 1) % 3

        monkeypatch.setattr(port_loop.torch.cuda, "Event", FakeEvent)
        batches = [{"patch_valid": np.array([True])} for _ in range(4)]
        out = port_loop.train(FakeTrainer(), schedule.CyclicLR(1e-4, 5e-4),
                              _ListLoader(batches), {"scheduler": {"type": "CyclicLR"}},
                              max_iteration=3)
        assert out["n_ministeps"] == 9 and FakeTrainer.most_live == 6
        # each step spans its end event's record after its start's: 1.5 ms
        assert out["step_ms"] == [1.5] * 9 and out["median_step_ms"] == 1.5
        assert [w["step_ms_median"] for w in out["windows"]] == [1.5] * 3
        del out
        assert FakeEvent.live == 0

    def test_no_valid_batch_raises(self):
        trainer = Trainer(build_model(train_cfg(), device="cpu"), {"optimize_every": 1})
        with pytest.raises(RuntimeError, match="no batch"):
            port_loop.train(trainer, schedule.CyclicLR(1e-4, 5e-4),
                            _ListLoader(make_batches(7, 1, valid=[False, False])),
                            {"scheduler": {"type": "CyclicLR"}}, max_iteration=1)


# --- the training loader on an on-disk synthetic dataset ------------------------------

BUCKET = 4096


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    import make_synthetic_city as msc

    root = str(tmp_path_factory.mktemp("torch_train"))
    msc.main(root, seed=1, density=0.1)
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=synthetic", f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud", f"output.output_folder={root}/generated",
        f"dataset.path={root}/generated",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        "dataset.patch_size=[128,128]", f"dataset.points.bucket_sizes=[{BUCKET}]",
        f"dataset.points.train_bucket={BUCKET}", "use_image=false"])
    build_dataset(cfg, overwrite=True)
    return cfg


def _port_dataset(jds, cfg, **kw):
    """The port's dataset over the JAX dataset's chunks and nDSM raster."""
    chunks = [{"name": jds.chunk_info[i]["name"], "min_bound": jds.chunk_info[i]["min_bound"],
               "max_bound": jds.chunk_info[i]["max_bound"], "points": jds.data_dic[i]["inputs"]}
              for i in jds.dataset_chunk_idx_ls]
    t = jds.dsm.T
    rows, cols = jds.dsm_data.shape
    raster = RasterData((t.c, t.f + t.e * rows), (t.c + t.a * cols, t.f), (t.a, -t.e))
    return SceneDataset(chunks, cfg["dataset"], dsm=(jds.dsm_data, raster), **kw)


def _assert_batches_equal(mine, ref):
    n = 0
    for a, b in zip(mine, ref):
        n += 1
        assert set(a) == set(b)
        for k in set(b) - {"name"}:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert a["name"] == b["name"]
    return n


class TestTrainingLoader:
    @pytest.mark.parametrize("det_stream", [True, False])
    def test_batches_match_jax(self, city, det_stream):
        jds = TomoSARDataset("train", city["dataset"], random_sample=True, random_length=7,
                             load_image=False)
        mine_ds = _port_dataset(jds, city, random_sample=True, random_length=7)
        kw = dict(fixed_bucket=BUCKET, sort_reso=RESO, shuffle=True, drop_last=True,
                  det_stream=det_stream, seed=3)
        ref = JaxPatchLoader(jds, 2, [BUCKET], aligned=True, **kw)
        mine = PatchLoader(mine_ds, 2, [BUCKET], **kw)
        assert len(mine) == len(ref) == 3
        for _ in range(2):  # two epochs: a new shuffle and new anchors each
            np.random.seed(11)  # the global generator draws when not det_stream
            ref_batches = list(ref)
            np.random.seed(11)
            assert _assert_batches_equal(list(mine), ref_batches) == 3
        assert ref_batches[0]["dsm"].shape == (2, 128, 128)

    def test_validation_patches_match_jax(self, city):
        jds = TomoSARDataset("val", city["dataset"], random_sample=False, load_image=False)
        mine = _port_dataset(jds, city, split="val")
        assert len(mine) == len(jds) > 0
        for i in range(len(jds)):
            a, b = mine[i], jds[i]
            assert set(a) <= set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)

