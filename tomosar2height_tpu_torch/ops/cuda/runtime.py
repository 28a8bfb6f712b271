"""Build, load and call the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` to an object file, all of
them at once (one compiler process per source), and the objects link into one
shared library with a plain C interface, loaded with ``ctypes``. The library
is built on first use into ``tomosar2height_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing is built or loaded at
import time.

Each kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel, so a run can show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_KERNELS = ("pool2", "pool_gather", "scatter_plane2", "fused_level", "fused_level_scatter",
            "fused_level_bwd", "level_d_plane", "level_bwd_reduce", "pool2_bwd",
            "scatter_plane2_bwd", "conv3x3", "conv_pair", "conv_decoder", "tile_gather",
            "tile_pool", "scatter_mean_plane", "aligned_scatter_mean_plane", "scatter_mean",
            "scatter_mean_plane_v3", "tile_gather_bwd", "tile_pool_bwd",
            "aligned_scatter_mean_plane_bwd")
LAUNCHES = {**{k: 0 for n in _KERNELS for k in (n, f"{n}_bf16")},
            "level_d_plane_wide_bf16": 0, "conv3x3_bf16_wgmma": 0, "conv3x3_bf16_flat": 0,
            "conv_pair_bf16_wgmma": 0, "conv_pair_bf16_flat": 0,
            "conv_decoder_bf16_wgmma": 0, "conv_decoder_bf16_flat": 0}
"""Kernel launches per wrapper since the last :func:`reset_launches`; each
kernel counts its launches on bf16 tensors under ``<name>_bf16``
(:func:`launched`); ``level_d_plane_wide_bf16`` counts the d_plane pass from
f32 cotangents into a bf16 plane; ``conv3x3_bf16_wgmma`` and
``conv3x3_bf16_flat`` split K8's bf16 launches by the route
``t2h_conv3x3_bf16`` takes (``tile_plan.conv_route``);
``conv_pair_bf16_wgmma`` and ``conv_pair_bf16_flat`` count K7's bf16 convs
(two a launch) by the route each takes, ``conv_decoder_bf16_wgmma`` and
``conv_decoder_bf16_flat`` K6's (three a launch, the third with the
head)."""

BUILD_INFO: dict = {}
"""Of the library this process loaded: path, whether it was built now, build
seconds and the compiler's log (``-Xptxas -v`` register/smem report)."""

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int

_SIGNATURES = {
    # name: argtypes (every function returns an int: cudaError_t, or the
    # count that t2h_level_bwd_reduce_tiles(_bf16) computes; the *_plan ones
    # write a plan's integers to their last argument)
    **{f"t2h_{name}{suffix}": argtypes for name, argtypes in (
        ("pool_runs", [_P] * 7 + [_I] * 5 + [_P]),
        ("pool_gather", [_P] * 5 + [_I] * 5 + [_P]),
        ("scatter_runs", [_P] * 7 + [_I] * 8 + [_P]),
        ("fused_level", [_P] * 11 + [_I] * 5 + [_P]),
        ("fused_level_bwd", [_P] * 18 + [_I] * 6 + [_P]),
        ("level_d_plane", [_P] * 6 + [_I] * 5 + [_P]),
        ("level_bwd_reduce", [_P, _P] + [_I] * 4 + [_P] * 4)) for suffix in ("", "_bf16")},
    "t2h_level_bwd_reduce_tiles": [_I, _I],
    "t2h_level_bwd_reduce_tiles_bf16": [_I, _I],
    "t2h_conv3x3": [_P] * 4 + [_I] * 6 + [_P],
    "t2h_conv_pair": [_P] * 8 + [_I] * 6 + [_P],
    "t2h_conv_decoder": [_P] * 12 + [_I] * 8 + [_P],
    "t2h_conv3x3_bf16": [_P] * 4 + [_I] * 6 + [_P],
    "t2h_conv_pair_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "t2h_conv_decoder_bf16": [_P] * 12 + [_I] * 8 + [_P],
    "t2h_tile_gather": [_P] * 4 + [_I] * 5 + [_P],
    "t2h_tile_gather_bf16": [_P] * 4 + [_I] * 5 + [_P],
    "t2h_pool_gather_cut_bf16": [_P] * 5 + [_I] * 5 + [_P],
    "t2h_level_d_plane_wide_bf16": [_P] * 6 + [_I] * 5 + [_P],
    "t2h_level_bwd_plan_bf16": [_I, _I, _P],
    "t2h_level_d_plane_plan": [_I] * 4 + [_P],
}


_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def entry(name: str, dtype: torch.dtype):
    """The C entry point ``t2h_<name>`` of the kernel's instance for
    ``dtype``: float32, or ``t2h_<name>_bf16`` for bfloat16."""
    return getattr(library(), f"t2h_{name}{_SUFFIX[dtype]}")


def launched(name: str, dtype: torch.dtype) -> None:
    """Count one launch of kernel ``name``'s instance for ``dtype``."""
    LAUNCHES[f"{name}{_SUFFIX[dtype]}"] += 1


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _sources() -> Sequence[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands at once and wait for every one; raise if any failed,
    with the output of each that did. Returns their joined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    failed = [f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}" for cmd, out, rc in outs if rc]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(out for _, out, _ in outs)


def _build(so_path: str, tag: str) -> str:
    """Compile every source to an object, all at once, then link the shared
    library; returns the compilers' output."""
    nvcc = nvcc_path()
    srcs = _sources()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    log = _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs))
    tmp = f"{so_path}.{tag}.tmp"
    log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, so_path)
    return log


def library() -> ctypes.CDLL:
    """The kernels' shared library: built with nvcc if missing, then loaded."""
    global _lib
    if _lib is not None:
        return _lib
    digest = _digest()
    so_path = os.path.join(BUILD_DIR, f"libt2h_kernels_{digest}.so")
    built, seconds, log = False, 0.0, ""
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        log = _build(so_path, f"{digest}.{os.getpid()}")
        seconds = time.perf_counter() - t0
        built = True
    lib = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.t2h_error_string.argtypes = [ctypes.c_int]
    lib.t2h_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(path=so_path, built=built, seconds=seconds, log=log)
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().t2h_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for CUDA (kernel); raises
    for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
