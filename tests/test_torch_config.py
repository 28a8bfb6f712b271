"""The port's configuration against the JAX package's: the YAML tree byte for
byte, ``compose()`` for each city with and without overrides and
interpolations, the named configurations, the CLI override parser, the
``Config`` helpers, and ``select_device`` (the ``device`` node)."""

from __future__ import annotations

import os

import pytest

from tomosar2height_tpu.config import compose as jax_compose
from tomosar2height_tpu.config.compose import Config as JaxConfig
from tomosar2height_tpu.config.compose import default_conf_dir as jax_conf_dir
from tomosar2height_tpu.config.compose import parse_cli_overrides as jax_parse
from tomosar2height_tpu_torch import config
from tomosar2height_tpu_torch.config import compose, default_conf_dir, parse_cli_overrides

CONF_FILES = ["config.yaml", "dataset/base.yaml", "dataset/berlin.yaml",
              "dataset/munich.yaml", "dataset/synthetic.yaml", "model/tomosar2height.yaml"]


def test_conf_dir_is_the_ports():
    package = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert default_conf_dir() == os.path.join(package, "conf")
    assert default_conf_dir() != jax_conf_dir()


def test_conf_tree_lists_the_same_files():
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    assert files(default_conf_dir()) == files(jax_conf_dir()) == sorted(CONF_FILES)


@pytest.mark.parametrize("name", CONF_FILES)
def test_conf_file_byte_equal(name):
    with open(os.path.join(default_conf_dir(), name), "rb") as f:
        mine = f.read()
    with open(os.path.join(jax_conf_dir(), name), "rb") as f:
        assert mine == f.read()


OVERRIDES = [
    [],
    # values, a list, a group-file key and keys that interpolations read
    ["gt_dsm=/data/city/ndsm.tif", "use_footprint=true", "use_image=true",
     "training.max_iteration=7", "dataset.patch_size=[128,128]",
     "model.encoder_kwargs.unet_kwargs.depth=3", "device.platform=cpu",
     "run_suffix=-v1", "test.check_point=/x/model_best.ckpt", "new.key.path=1e-3"],
    ["model=tomosar2height", "dataset.points.sort=true",
     "model.encoder_kwargs.sorted_impl=fused2", "dataset.normalize.z_shift=global_min"],
]


@pytest.mark.parametrize("dataset", ["berlin", "munich", "synthetic"])
@pytest.mark.parametrize("which", range(len(OVERRIDES)))
def test_compose_matches_jax(dataset, which):
    ov = [f"dataset={dataset}"] + OVERRIDES[which]
    mine = compose(default_conf_dir(), overrides=ov)
    ref = jax_compose(jax_conf_dir(), overrides=ov)
    assert isinstance(mine, dict)
    assert mine.to_dict() == ref.to_dict()
    assert mine["dataset"]["dsm_gt_path"] == mine["gt_dsm"]  # ${gt_dsm}
    assert mine["model"]["decoder_pixel_kwargs"]["use_footprint"] is mine["use_footprint"]


def test_compose_default_city_matches_jax():
    assert compose(default_conf_dir()).to_dict() == jax_compose(jax_conf_dir()).to_dict()


@pytest.mark.parametrize("name,overrides", [
    ("flagship", ["dataset=berlin"] + config.KERNEL_PATH),
    ("fusion", ["dataset=berlin", "use_image=true"] + config.KERNEL_PATH + config.CONV_KERNELS),
    ("headline", ["dataset=munich", "use_image=true"] + config.KERNEL_PATH
     + config.CONV_KERNELS),
    ("sorted_fused", ["dataset=berlin", "dataset.points.sort=true",
                      "model.encoder_kwargs.sorted_impl=fused"]),
    ("sorted_cumsum", ["dataset=berlin", "dataset.points.sort=true",
                       "model.encoder_kwargs.sorted_impl=cumsum"]),
])
def test_named_configs_are_compose(name, overrides):
    """Every key of the named configurations, not only the ones the dict
    literals carried before, equals JAX ``compose()`` of the overrides."""
    fn = (lambda: config.sorted_config(name.split("_")[1])) if name.startswith("sorted") \
        else getattr(config, f"{name}_config")
    mine = fn()
    assert mine.to_dict() == jax_compose(jax_conf_dir(), overrides=overrides).to_dict()
    assert fn() is not mine  # a fresh tree every call


def test_named_configs_keys():
    h = config.headline_config()
    assert h["use_image"] and h["use_footprint"]
    assert h["model"]["encoder_kwargs"]["unet_kwargs"]["depth"] == 6
    assert h["model"]["decoder_pixel_kwargs"]["fused_head"] is True
    assert config.flagship_config()["model"]["encoder_kwargs"]["sorted_impl"] == "fused2"
    assert config.flagship_config()["use_image"] is False


TOKENS = ["a=1", "b.c=true", "d=[1, 2]", "e=", "f=null", "g=x=y", "h=1e-4", "i='s'",
          "j={k: 2}"]


def test_parse_cli_overrides_matches_jax():
    assert parse_cli_overrides(TOKENS) == jax_parse(TOKENS)
    for bad in (["novalue"], ["a=1", "b"]):
        with pytest.raises(ValueError, match="key=value"):
            parse_cli_overrides(bad)
        with pytest.raises(ValueError, match="key=value"):
            jax_parse(bad)


def test_interpolation_errors_match_jax(tmp_path):
    (tmp_path / "config.yaml").write_text("defaults:\n  - _self_\na: ${b}\nb: ${a}\n"
                                          "c: ${missing.key}\n")
    for fn in (compose, jax_compose):
        with pytest.raises(ValueError, match="cycle"):
            fn(str(tmp_path), overrides=["c=1"])
        with pytest.raises(KeyError, match="not found"):
            fn(str(tmp_path), overrides=["a=1"])
    (tmp_path / "config.yaml").write_text("defaults:\n  - _self_\nx: 2\ny: 'v${x}w'\n"
                                          "z: ${x}\n")
    mine = compose(str(tmp_path))
    assert mine.to_dict() == jax_compose(str(tmp_path)).to_dict() == {
        "x": 2, "y": "v2w", "z": 2}


def test_config_helpers_match_jax():
    tree = {"a": {"b": [10, {"c": 3}]}, "d": 1}
    mine, ref = config.Config(tree), JaxConfig(tree)
    for path in ("a.b.1.c", "a.b.0", "a.x", "d", "a.b.-1.c"):
        assert mine.select(path, "no") == ref.select(path, "no")
    for c in (mine, ref):
        c.set_path("a.e.f", 5)
        c.set_path("d", 2)
    assert mine.to_dict() == ref.to_dict()
    assert mine.a.e.f == 5 and mine.get("q", 7) == 7
    with pytest.raises(AttributeError):
        mine.nothing


def test_select_device_cpu_and_card():
    assert config.select_device({"device": {"platform": "cpu"}}).type == "cpu"
    cfg = compose(default_conf_dir(), overrides=["device.platform=cpu"])
    assert config.select_device(cfg).type == "cpu"
    import torch

    if torch.cuda.is_available():
        assert config.select_device(compose(default_conf_dir())).type == "cuda"
    else:
        # null names the card: no card, no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA card"):
            config.select_device(compose(default_conf_dir()))


@pytest.mark.parametrize("override,error,match", [
    ("device.dtype=bfloat16", NotImplementedError, "compute dtype is model.dtype"),
    ("device.mesh.data=2", NotImplementedError, "ROADMAP: data parallelism"),
    ("device.distributed.num_processes=2", NotImplementedError, "ROADMAP: data parallelism"),
    ("device.platform=tpu", ValueError, "device.platform"),
])
def test_select_device_refuses_what_it_cannot_honour(override, error, match):
    cfg = compose(default_conf_dir(), overrides=["device.platform=cpu", override])
    with pytest.raises(error, match=match):
        config.select_device(cfg)


def test_select_device_reads_the_keys_it_does_not_act_on():
    cfg = compose(default_conf_dir(), overrides=[
        "device.platform=cpu", "device.mesh.data=1", "device.donate=false",
        "device.distributed.coordinator=null"])
    assert config.select_device(cfg).type == "cpu"
