"""The port's checkpoints against the JAX package's, and kill-and-resume.

- A port-written checkpoint loads in the JAX ``CheckpointIO.load`` into a
  ``TrainState``'s templates with equal parameters, Adam ``count``/``mu``/
  ``nu``, scalars and scheduler state; the port writes the model and a fresh
  optimizer state byte for byte as flax's ``to_bytes`` does.
- A JAX-written checkpoint, after two JAX optimizer steps, loads in the
  port with the same state, and one more optimizer step from it agrees with
  JAX's at ``test_torch_train``'s trajectory tolerance (window loss 1e-4
  rel; the parameters as updates since the checkpoint, 2e-3 overall and
  2e-2 a tensor). The JAX side runs the network's plain (unsorted) path on
  the same points, the port fused2.
- Kill-and-resume through ``train/loop.py`` on the CPU is bit-exact
  (``torch.equal`` on every tensor, equal window losses) for the fusion
  network with its footprint head on the port's synthetic city, mid-epoch and
  at an epoch boundary, with the stream position in the file
  (tests/test_resume_bitexact.py:88,110,129 for the JAX package).
- ``resume_scheduler=False``, a missing file (a resume from one trains from
  scratch), a URL, lenient loads, the
  atomic write, the optimizer state in the middle of a window, and every
  scheduler's state dict against JAX's (the file stores it).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.serialization as fser  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train as ttt  # noqa: E402
from tomosar2height_tpu.models import build_model as jax_build_model  # noqa: E402
from tomosar2height_tpu.parallel.mesh import make_mesh, replicate  # noqa: E402
from tomosar2height_tpu.train import schedule as jax_schedule  # noqa: E402
from tomosar2height_tpu.train.checkpoint import CheckpointIO as JaxCheckpointIO  # noqa: E402
from tomosar2height_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tomosar2height_tpu.train.trainer import TrainState, make_optimizer  # noqa: E402
from tomosar2height_tpu_torch.data import PatchLoader, SceneDataset  # noqa: E402
from tomosar2height_tpu_torch.data.synthetic import X0, Y0, build_city  # noqa: E402
from tomosar2height_tpu_torch.geo import RasterData  # noqa: E402
from tomosar2height_tpu_torch.models import build_model, init_weights  # noqa: E402
from tomosar2height_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from tomosar2height_tpu_torch.train import loop, schedule  # noqa: E402
from tomosar2height_tpu_torch.train.checkpoint import CheckpointIO, pack, unpack  # noqa: E402
from tomosar2height_tpu_torch.train.trainer import Trainer  # noqa: E402
from tomosar2height_tpu_torch.utils.torch_port import (  # noqa: E402
    flatten_tree,
    load_optax_state,
    optimizer_to_optax,
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


CYCLIC = dict(base_lr=1e-3, max_lr=4e-3, step_size_up=3, mode="triangular2")


def jax_batch(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k not in ("cell", "cell_offsets")}


@pytest.fixture(scope="module")
def jax_params():
    b = ttt.make_batches(0, 1)[0]
    return jax.tree.map(np.asarray, jax.jit(jax_build_model(ttt.train_cfg("cumsum")).init)(
        jax.random.PRNGKey(0), jnp.asarray(b["points"]), jnp.asarray(b["point_mask"])))


def _jax_templates(params):
    return params, make_optimizer(2).init(params)


def _leaves_equal(a: dict, b: dict):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))


def _adam(trainer, key):
    names = [n for n, _ in trainer.model.named_parameters()]
    return state_dict_to_flax({n: trainer.optimizer.state[p][key]
                               for n, p in zip(names, trainer.params)})


@pytest.mark.parametrize("optimize_every", [2, 1])
def test_fresh_state_is_written_as_flax_writes_it(jax_params, tmp_path, optimize_every):
    """optax.MultiSteps around Adam, or Adam's chain alone at 1."""
    trainer = ttt.port_trainer(jax_params, optimize_every=optimize_every)
    snap = CheckpointIO(str(tmp_path), model=trainer.model, optimizer=trainer).snapshot()
    assert snap["pytrees"]["model"] == fser.to_bytes(jax_params)
    want = fser.to_bytes(make_optimizer(optimize_every).init(jax_params))
    assert snap["pytrees"]["optimizer"] == want
    load_optax_state(trainer, unpack(want))
    assert not trainer.optimizer.state and trainer.mini_step == 0


def test_port_checkpoint_loads_in_jax(jax_params, tmp_path):
    trainer = ttt.port_trainer(jax_params)
    sched = schedule.CyclicLR(**CYCLIC)
    for b in ttt.make_batches(5, 4):
        trainer.train_step(b, sched.lr)
        if trainer.accumulated_steps == 0:
            sched.step()
    path = str(tmp_path / "model_2.ckpt")
    CheckpointIO(str(tmp_path), model=trainer.model, optimizer=trainer, scheduler=sched).save(
        path, n_iter=2, loss_val_best=0.25, stream_pos=(1, 2), training_time=1.5)
    params_t, opt_t = _jax_templates(jax_params)
    jsched = jax_schedule.CyclicLR(**CYCLIC)
    io = JaxCheckpointIO(str(tmp_path), model=params_t, optimizer=opt_t, scheduler=jsched)
    scalars = io.load(path)
    assert scalars == {"n_iter": 2, "loss_val_best": 0.25, "stream_pos": [1, 2],
                       "training_time": 1.5}
    assert jsched.state_dict() == sched.state_dict() and jsched.lr == sched.lr
    sd = {k: v.detach() for k, v in trainer.model.named_parameters()}
    _leaves_equal(io.module_dict["model"], state_dict_to_flax(sd))
    opt = io.module_dict["optimizer"]
    adam = opt.inner_opt_state[0]
    assert int(adam.count) == 2 and int(opt.gradient_step) == 2 and int(opt.mini_step) == 0
    _leaves_equal(adam.mu, _adam(trainer, "exp_avg"))
    _leaves_equal(adam.nu, _adam(trainer, "exp_avg_sq"))
    assert not any(np.any(x) for x in jax.tree.leaves(opt.acc_grads))


def test_jax_checkpoint_resumes_in_the_port(jax_params, tmp_path):
    """Two JAX windows, a JAX checkpoint, then one more window on each side."""
    jtrainer = JaxTrainer(jax_build_model(ttt.train_cfg("cumsum")),
                          {"optimize_every": 2, "wire_dsm_dtype": "float32"},
                          use_cloud=True, mesh=make_mesh(1), donate=False)
    params_t, opt_t = _jax_templates(jax_params)
    state = replicate(TrainState(params_t, opt_t, jnp.zeros((), jnp.int32),
                                 jnp.zeros((5,), jnp.float32)), jtrainer.mesh)
    jsched = jax_schedule.CyclicLR(**CYCLIC)
    batches = ttt.make_batches(6, 6)
    for b in batches[:4]:
        state = jtrainer.train_step(state, jax_batch(b), jsched.lr)
        if jtrainer.accumulated_steps == 0:
            jsched.step()
    path = str(tmp_path / "model_2.ckpt")
    params_ckpt = jax.tree.map(np.asarray, state.params)
    JaxCheckpointIO(str(tmp_path), model=params_ckpt,
                    optimizer=jax.tree.map(np.asarray, state.opt_state),
                    scheduler=jsched).save(path, n_iter=2, loss_val_best=float("inf"),
                                           stream_pos=[3, 1], training_time=2.0)
    torch.manual_seed(3)
    trainer = Trainer(build_model(ttt.train_cfg(), device="cpu"),
                      {"optimize_every": 2, "wire_dsm_dtype": "float32"})
    sched = schedule.CyclicLR(**CYCLIC)
    io = CheckpointIO(str(tmp_path / "port"), model=trainer.model, optimizer=trainer,
                      scheduler=sched)
    scalars = io.load(path)
    assert scalars == {"n_iter": 2, "loss_val_best": float("inf"), "stream_pos": [3, 1],
                       "training_time": 2.0}
    assert sched.state_dict() == jsched.state_dict()
    sd = {k: v.detach() for k, v in trainer.model.named_parameters()}
    _leaves_equal(state_dict_to_flax(sd), params_ckpt)
    adam = jax.tree.map(np.asarray, state.opt_state.inner_opt_state[0])
    assert all(float(s["step"]) == 2.0 for s in trainer.optimizer.state.values())
    _leaves_equal(_adam(trainer, "exp_avg"), adam.mu)
    _leaves_equal(_adam(trainer, "exp_avg_sq"), adam.nu)
    assert trainer.accumulated_steps == 0 and trainer.mini_step == 4
    for b in batches[4:]:
        state = jtrainer.train_step(state, jax_batch(b), jsched.lr)
        trainer.train_step(b, sched.lr)
    ttt.TestTrainStep._check(([trainer.last_avg_loss], trainer), [jtrainer.last_avg_loss],
                             params_ckpt, state)


def test_optimizer_state_in_the_middle_of_a_window():
    """optax keeps the running mean of the window's gradients (times the
    window under 'sum'); the port's sum comes back from it."""
    for red in ("mean", "sum"):
        torch.manual_seed(4)
        cfg = {"optimize_every": 3, "grad_reduction": red}
        trainer = Trainer(build_model(ttt.train_cfg(), device="cpu"), cfg)
        for b in ttt.make_batches(7, 2):  # two mini-steps of the first window
            trainer.train_step(b, 1e-3)
        tree = unpack(pack(optimizer_to_optax(trainer)))
        assert int(tree["mini_step"]) == 2 and int(tree["gradient_step"]) == 0
        names = [n for n, _ in trainer.model.named_parameters()]
        scale = (3 if red == "sum" else 1) / 2
        want = state_dict_to_flax({n: g * scale for n, g in zip(names, trainer._grad_sum)})
        _leaves_equal(tree["acc_grads"], want)
        fresh = Trainer(build_model(ttt.train_cfg(), device="cpu"), cfg)
        fresh.model.load_state_dict(trainer.model.state_dict())
        load_optax_state(fresh, tree)
        assert fresh.accumulated_steps == 2 and fresh.mini_step == 2
        for a, b in zip(fresh._grad_sum, trainer._grad_sum):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        b = ttt.make_batches(8, 1)[0]
        trainer.train_step(b, 1e-3)
        fresh.train_step(b, 1e-3)
        for p, q in zip(fresh.params, trainer.params):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,kwargs", ttt.TestSchedulers.CASES)
def test_scheduler_state_dicts_match_jax(name, kwargs):
    mine, ref = schedule.SCHEDULERS[name](**kwargs), jax_schedule.SCHEDULERS[name](**kwargs)
    metrics = [1.0, 0.9, 0.95, 0.96, 0.5, 0.6]
    for i in range(6):
        m = metrics[i] if name == "ReduceLROnPlateau" else None
        mine.step(m)
        ref.step(m)
        assert mine.state_dict() == ref.state_dict(), (name, i)
    assert unpack(pack(mine.state_dict())) == ref.state_dict()


# --- kill-and-resume through the loop ------------------------------------------------

W, H = 384, 256


@pytest.fixture(scope="module")
def city():
    ndsm, pts, rgb = build_city(3, density=0.05, n_buildings=12, W=W, H=H)
    chunks = [{"name": "city", "min_bound": [X0, Y0], "max_bound": [X0 + W, Y0 + H],
               "points": pts}]
    grid = RasterData((X0, Y0), (X0 + W, Y0 + H), (1.0, 1.0))
    return chunks, (ndsm, grid), (rgb, grid)


def _cfg():
    from test_torch_fusion_train import fusion_train_cfg

    cfg = fusion_train_cfg()
    cfg["model"]["decoder_pixel_kwargs"]["output_size"] = 64
    cfg["dataset"].update({
        "patch_size": [64, 64],
        "normalize": {"x_range": [0.0, 1.0], "y_range": [0.0, 1.0], "z_shift": "local_min",
                      "z_bound": [0.0, 60.0]},
        "satellite_image": {"normalize": {"mean": [128.0] * 3, "std": [64.0] * 3}}})
    cfg["training"] = {"optimize_every": 2, "learning_rate": 1e-3, "checkpoint_every": 1,
                       "scheduler": {"type": "CyclicLR", "kwargs": dict(CYCLIC)}}
    return cfg


def _run(city, out_dir, max_iteration, resume_from=None):
    """Fresh network, trainer, scheduler and loader; the loop to
    ``max_iteration`` (8 patches an epoch at batch 2: two iterations)."""
    chunks, dsm, image = city
    cfg = _cfg()
    # other initial weights when resuming: they must come from the file
    model = init_weights(build_model(cfg, device="cpu"),
                         torch.Generator().manual_seed(2 if resume_from else 1))
    trainer = Trainer(model, cfg["training"], use_image=True, use_footprint=True)
    ds = SceneDataset(chunks, cfg["dataset"], random_sample=True, random_length=8, dsm=dsm,
                      image=image)
    loader = PatchLoader(ds, 2, [1024], fixed_bucket=1024, sort_reso=32, shuffle=True,
                         drop_last=True, seed=1, det_stream=True)
    out = loop.train(trainer, schedule.build_scheduler(cfg["training"]), loader,
                     cfg["training"], max_iteration=max_iteration,
                     checkpoint_io=CheckpointIO(out_dir), resume_from=resume_from)
    return out, {k: v.detach().clone() for k, v in model.state_dict().items()}, trainer


@pytest.fixture(scope="module")
def straight(city, tmp_path_factory):
    """Three iterations from scratch: ``resume_from`` names a file the
    directory does not hold."""
    out_dir = str(tmp_path_factory.mktemp("straight"))
    return out_dir, _run(city, out_dir, 3, resume_from=ckpt.DEFAULT_MODEL_FILE)


@pytest.mark.parametrize("resume_at", [1, 2])
def test_kill_and_resume_is_bit_exact(city, straight, tmp_path, resume_at):
    """Resume at iteration 1 (mid-epoch) or 2 (the epoch's end) from the
    straight run's checkpoint, in fresh objects, and run on to 3."""
    out_dir, (ref, ref_state, ref_trainer) = straight
    assert not ref["resumed"] and ref["n_iter"] == 3
    out, state, trainer = _run(city, str(tmp_path), 3,
                               resume_from=os.path.join(out_dir, f"model_{resume_at}.ckpt"))
    assert out["resumed"] and out["n_iter"] == 3
    assert [w["iteration"] for w in out["windows"]] == list(range(resume_at + 1, 4))
    assert [w["loss"] for w in out["windows"]] == [w["loss"] for w in ref["windows"][resume_at:]]
    assert [w["loss_ce"] for w in out["windows"]] == \
        [w["loss_ce"] for w in ref["windows"][resume_at:]]
    assert ref["windows"][0]["loss_ce"] > 0
    assert sorted(state) == sorted(ref_state)
    assert all(torch.equal(state[k], ref_state[k]) for k in state)
    for p, q in zip(trainer.params, ref_trainer.params):
        s, r = trainer.optimizer.state[p], ref_trainer.optimizer.state[q]
        assert all(torch.equal(s[k], r[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert out["stream_pos"] == ref["stream_pos"] == (2, 2)


def test_stream_pos_in_checkpoint(city, straight):
    out_dir = straight[0]
    pos = []
    for n in (1, 2, 3):
        io = CheckpointIO(out_dir)
        scalars = io.load(os.path.join(out_dir, f"model_{n}.ckpt"))
        assert scalars["n_iter"] == n and scalars["training_time"] > 0
        pos.append(scalars["stream_pos"])
    assert pos == [[1, 2], [1, 4], [2, 2]]


def test_resume_scheduler_false_and_missing_entries(city, straight, caplog):
    out_dir = straight[0]
    sched = schedule.CyclicLR(**CYCLIC)
    io = CheckpointIO(out_dir, scheduler=sched, extra={"a": np.zeros(2)})
    scalars = io.load(os.path.join(out_dir, "model_3.ckpt"), resume_scheduler=False)
    assert sched.last_step == 0 and "scheduler" not in scalars and scalars["n_iter"] == 3
    assert "Could not find extra" in caplog.text
    io.load(os.path.join(out_dir, "model_3.ckpt"))
    assert sched.last_step == 3


def test_missing_file_and_url(tmp_path):
    io = CheckpointIO(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        io.load(str(tmp_path / "nope.ckpt"))
    with pytest.raises(FileNotFoundError):
        io.load("")
    with pytest.raises(NotImplementedError, match="ROADMAP: datasets on disk"):
        io.load("https://example.invalid/model.ckpt")


def test_write_is_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "m.ckpt")
    io = CheckpointIO(str(tmp_path), tree={"w": np.arange(3.0)})
    io.save(path, n_iter=1)
    before = open(path, "rb").read()
    io.module_dict["tree"] = {"w": np.arange(4.0)}

    def fail(src, dst):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt.os, "replace", fail)
    with pytest.raises(OSError):
        io.save(path, n_iter=2)
    assert open(path, "rb").read() == before
    assert unpack(unpack(open(path + ".tmp", "rb").read())["pytrees"]["tree"])["w"].size == 4
    monkeypatch.undo()
    assert CheckpointIO(str(tmp_path), tree={}).load(path) == {"n_iter": 1}
