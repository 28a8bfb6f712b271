"""Why K4 and K5's weight-gradient reduction take three TF32 products.

Both kernels (``csrc/level.cu``, ``csrc/level_bwd.cu``) multiply on the
tensor cores with the split of ``csrc/mma_tf32x3.cuh``: each fp32 operand x
becomes hi = rna_tf32(x) and lo = rna_tf32(x - hi), and a product is
lo*hi + hi*lo + hi*hi. This file emulates that arithmetic on the CPU with
integer ops on the floats' bits (``cvt.rna``: round the 13 dropped mantissa
bits to nearest, ties away from zero) and fp32 accumulation in the kernels'
order of k8 steps (each m16n8k8 MMA adds the exact sum of its eight products
to the fp32 accumulator), and holds the result to float64:

- K4 at its widths (F 32 and 512, Fl 256 and 1024): within the kernel's
  tolerance against its plain version (1e-5 abs + rel; chip_smoke.TOL);
- an A^T B over 131072 rows split as the reduction splits it: within the
  weight gradients' tolerance (3e-4 * max|ref| abs + 3e-4 rel;
  chip_smoke.WEIGHT_RTOL);
- and one TF32 pass alone is not within 1e-5 at K4's widths.

What it leaves out: the tensor cores truncate as they add inside a chain of
MMAs into one accumulator, and the emulation rounds each k8 step exactly. It
backs the three-product split, not the kernels' chain length (a few k8 steps
into a zeroed accumulator, joined to the running sum by a rounded add): a
kernel chaining all of K would pass here. The card tests guard that
(``tests/test_torch_cuda.py``, K4 and the reduction against their plain
versions at 1e-5 and the weight tolerance).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

TOL = 1e-5
WEIGHT_RTOL = 3e-4


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero
    (on the magnitude bits, so the sign needs no case)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def mma_matmul(a: torch.Tensor, w: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a (M, K) @ w (K, N) as the kernels take it: k8 steps in order, each
    adding its three (or one) TF32 products, summed exactly, to an fp32
    accumulator, small terms first."""
    a_hi, a_lo = split(a.float())
    w_hi, w_lo = split(w.float())
    terms = [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)] if passes == 3 else [(a_hi, w_hi)]
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in terms:
            step = x[:, k:k + 8].double() @ y[k:k + 8].double()
            acc = (acc.double() + step).float()
    return acc


def _xavier(rng, fan_in, fan_out):
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    return rng.uniform(-a, a, (fan_in, fan_out)).astype(np.float32)


def level_o(s, c_last, w, matmul):
    """K4's per-row function (its order: c_last @ w_c, then the hidden
    chunks of h @ w_out, then the biases)."""
    w_in, b_in, w_out, b_out, w_c, b_c = w
    h = torch.relu(matmul(s, w_in) + b_in)
    return matmul(torch.cat([c_last, h], 1), torch.cat([w_c, w_out], 0)) + b_out + b_c


def level_case(f, fl, rows=256, seed=0):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.normal(size=(rows, f)).astype(np.float32))
    c_last = torch.from_numpy(rng.normal(size=(rows, fl)).astype(np.float32))
    w = tuple(torch.from_numpy(x) for x in (
        _xavier(rng, f, 2 * f), rng.normal(0, 0.1, 2 * f).astype(np.float32),
        _xavier(rng, 2 * f, f), rng.normal(0, 0.1, f).astype(np.float32),
        _xavier(rng, fl, f), rng.normal(0, 0.1, f).astype(np.float32)))
    truth = level_o(s.double(), c_last.double(), tuple(x.double() for x in w),
                    lambda x, y: x @ y)
    return s, c_last, w, truth


def _within(got, truth, atol, rtol):
    return bool(((got.double() - truth).abs() <= atol + rtol * truth.abs()).all())


def test_rna_rounding_on_the_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0,
                         3.0e-39], dtype=torch.float32)
    got = to_tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(x)
    assert torch.equal((hi + lo)[:5], x[:5])


@pytest.mark.parametrize("f,fl", [(32, 256), (512, 256), (512, 1024)])
def test_three_tf32_products_hold_k4_tolerance(f, fl):
    s, c_last, w, truth = level_case(f, fl, seed=f + fl)
    got = level_o(s, c_last, w, mma_matmul)
    assert _within(got, truth, TOL, TOL), float((got.double() - truth).abs().max())


@pytest.mark.parametrize("f,fl", [(32, 256), (512, 1024)])
def test_one_tf32_pass_misses_k4_tolerance(f, fl):
    s, c_last, w, truth = level_case(f, fl, seed=f + fl)
    got = level_o(s, c_last, w, lambda x, y: mma_matmul(x, y, passes=1))
    assert not _within(got, truth, TOL, TOL)
    assert float((got.double() - truth).abs().max()) > 1e-4


def test_three_tf32_products_hold_the_weight_gradient_tolerance():
    """A^T B over 131072 rows in 64 row splits (each accumulated in its own
    fp32 accumulator, k8 step by k8 step), the splits then summed in order,
    as ``t2h_level_bwd_reduce`` does."""
    rng = np.random.default_rng(5)
    m, ka, nb, splits = 131072, 16, 24, 64
    a = torch.from_numpy(rng.normal(size=(m, ka)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(m, nb)).astype(np.float32))
    truth = a.double().t() @ b.double()
    at_hi, at_lo = split(a.t().reshape(ka, splits, m // splits).transpose(0, 1))
    b_hi, b_lo = split(b.reshape(splits, m // splits, nb))
    acc = torch.zeros(splits, ka, nb, dtype=torch.float32)
    for k in range(0, m // splits, 8):
        for x, y in ((at_lo, b_hi), (at_hi, b_lo), (at_hi, b_hi)):
            step = x[:, :, k:k + 8].double() @ y[:, k:k + 8].double()
            acc = (acc.double() + step).float()
    got = torch.zeros(ka, nb, dtype=torch.float32)
    for sp in range(splits):
        got = got + acc[sp]
    atol = WEIGHT_RTOL * float(truth.abs().max())
    assert _within(got, truth, atol, WEIGHT_RTOL)
    # the split alone is what holds it: the same sum of one TF32 pass is
    # ~2^-11 off in every product
    one = (to_tf32(a).double().t() @ to_tf32(b).double())
    assert float((one - truth).abs().max()) > 10 * float((got.double() - truth).abs().max())
