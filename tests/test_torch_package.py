"""The PyTorch port imports no JAX and nothing of the JAX package, and its
kernel paths swallow no error.

``tests/conftest.py`` imports JAX into every test process, so the import
check runs in a fresh interpreter."""

from __future__ import annotations

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tomosar2height_tpu_torch")


def _sources(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tomosar2height_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "assert {'tomosar2height_tpu_torch.train.' + m for m in\n"
        "        ('loop', 'schedule', 'trainer')} <= set(names), names\n"
        "assert {'tomosar2height_tpu_torch.' + m for m in\n"
        "        ('models.unet', 'ops.cuda.conv_kernel', 'ops.cuda.convpair_kernel',\n"
        "         'ops.cuda.decoder_kernel', 'ops.cuda.gather_kernel',\n"
        "         'ops.cuda.pool_kernel', 'ops.cuda.scatter_kernel', 'ops.fused')\n"
        "        } <= set(names), names\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tomosar2height_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|tomosar2height_tpu|make_synthetic_city)\b"
        r"(?!_torch)", re.M)
    for path in list(_sources(PKG)) + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            src = f.read()
        assert not pattern.search(src), path
        assert "tomosar2height_tpu import" not in src, path


def test_kernel_paths_have_no_exception_handlers():
    """A CUDA tensor either launches its kernel or raises: no handler in the
    kernel wrappers or the smoke may catch a build, launch or compare error."""
    paths = list(_sources(os.path.join(PKG, "ops"))) + [os.path.join(REPO, "chip_smoke.py")]
    for path in paths:
        with open(path) as f:
            assert not re.search(r"^\s*except\b", f.read(), re.M), path
