"""Why the tensor-core kernels take three TF32 products.

K4 (``csrc/level.cu``), K5's row pass and weight-gradient reduction
(``csrc/level_bwd.cu``) and the implicit-GEMM convs of K6, K7 and K8
(``csrc/igemm_conv.cuh``) multiply on the tensor cores with the split of ``csrc/mma_tf32x3.cuh``: each fp32 operand x
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
- K5's row pass at F = 512, Fl = 256: its four contractions within K4's
  1e-5 (pre) and K5's 2e-5 abs + 2e-4 rel (d_c_last, d_h, d_s);
- a conv over K = 9 * 1024 (K7's deepest): within 1e-5 abs + rel;
- K6's chain, three convs 32 -> 64 -> 128 -> 64 each reading the last one's
  rounded output, and its 288 -> 1 head in fp32: x1..x3 and the output
  within 1e-5 abs + rel of the float64 plain decoder;
- K8 without its ReLU, on the flat-K steps (Cin 3 and 33): within 1e-5;
- and one TF32 pass alone is not within 1e-5 at K4's widths.

The float64 products of every k8 step come from batched matmuls; only the
ordered fp32 adds run in a Python loop.

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

from tomosar2height_tpu_torch.ops.cuda.conv_kernel import conv3x3_plain
from tomosar2height_tpu_torch.ops.cuda.decoder_kernel import conv_decoder_plain

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


def k8_products(x: torch.Tensor, y: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """The exact (float64) product of each k8 step s0 <= s < s1 of x (..., M,
    K) @ y (..., K, N): (s1 - s0, ..., M, N), in one batched matmul."""
    xs = x[..., 8 * s0:8 * s1].double().unflatten(-1, (s1 - s0, 8)).movedim(-2, 0)
    ys = y[..., 8 * s0:8 * s1, :].double().unflatten(-2, (s1 - s0, 8)).movedim(-3, 0)
    return xs @ ys


def mma_sum(terms, batch_steps: int = 32) -> torch.Tensor:
    """sum over k8 steps, in order, of each (x, y) term's step product, each
    added to an fp32 accumulator with one rounding (K padded to a multiple
    of 8 with zeros). The products come batched, ``batch_steps`` steps at a
    time; only the ordered fp32 adds run one by one."""
    x0, y0 = terms[0]
    k = x0.shape[-1]
    pad = (-k) % 8
    terms = [(torch.nn.functional.pad(x, (0, pad)),
              torch.nn.functional.pad(y, (0, 0, 0, pad))) for x, y in terms]
    acc = torch.zeros(x0.shape[:-1] + y0.shape[-1:], dtype=torch.float32)
    steps = (k + pad) // 8
    for s0 in range(0, steps, batch_steps):
        s1 = min(steps, s0 + batch_steps)
        prods = [k8_products(x, y, s0, s1) for x, y in terms]
        for i in range(s1 - s0):
            for p in prods:
                acc = (acc.double() + p[i]).float()
    return acc


def mma_matmul(a: torch.Tensor, w: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a (M, K) @ w (K, N) as the kernels take it: k8 steps in order, each
    adding its three (or one) TF32 products, summed exactly, to an fp32
    accumulator, small terms first."""
    a_hi, a_lo = split(a.float())
    w_hi, w_lo = split(w.float())
    terms = [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)] if passes == 3 else [(a_hi, w_hi)]
    return mma_sum(terms)


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
    acc = mma_sum([(at_lo, b_hi), (at_hi, b_lo), (at_hi, b_hi)])
    got = torch.zeros(ka, nb, dtype=torch.float32)
    for sp in range(splits):
        got = got + acc[sp]
    atol = WEIGHT_RTOL * float(truth.abs().max())
    assert _within(got, truth, atol, WEIGHT_RTOL)
    # the split alone is what holds it: the same sum of one TF32 pass is
    # ~2^-11 off in every product
    one = (to_tf32(a).double().t() @ to_tf32(b).double())
    assert float((one - truth).abs().max()) > 10 * float((got.double() - truth).abs().max())


BWD_TOL = (2e-5, 2e-4)  # K5's d_plane and d_c_last (chip_smoke.BWD_TOL)


def test_three_tf32_products_hold_the_row_pass_tolerances():
    """K5's row pass at the F = 512 level (Fl = 256), its four contractions
    in the kernel's order: pre = s W_in (+ b_in), d_c_last = d_o W_c^T,
    d_h = (d_o W_out^T) [pre > 0], d_s = d_h W_in^T (the hidden layer's
    64-column chunks in order, which is the k order). pre within K4's 1e-5
    (it opens the gates), d_c_last and d_s within K5's 2e-5 abs + 2e-4 rel;
    the gate is the float64 one on both sides (the kink is the card tests'
    business, chip_smoke.KINK)."""
    f, fl, rows = 512, 256, 256
    rng = np.random.default_rng(23)
    s = torch.from_numpy(rng.normal(size=(rows, f)).astype(np.float32))
    d_o = torch.from_numpy(rng.normal(size=(rows, f)).astype(np.float32))
    w_in, w_out, w_c = (torch.from_numpy(_xavier(rng, *sh))
                        for sh in ((f, 2 * f), (2 * f, f), (fl, f)))
    b_in = torch.from_numpy(rng.normal(0, 0.1, 2 * f).astype(np.float32))
    pre_t = s.double() @ w_in.double() + b_in.double()
    gate = pre_t > 0
    pre = mma_matmul(s, w_in) + b_in
    assert _within(pre, pre_t, TOL, TOL), float((pre.double() - pre_t).abs().max())
    d_c = mma_matmul(d_o, w_c.t())
    assert _within(d_c, d_o.double() @ w_c.double().t(), *BWD_TOL)
    d_h = mma_matmul(d_o, w_out.t()) * gate
    d_h_t = (d_o.double() @ w_out.double().t()) * gate
    assert _within(d_h, d_h_t, *BWD_TOL)
    d_s = mma_matmul(d_h, w_in.t())
    d_s_t = d_h_t @ w_in.double().t()
    assert _within(d_s, d_s_t, *BWD_TOL), float((d_s.double() - d_s_t).abs().max())


def test_three_tf32_products_hold_the_conv_tolerance_at_k_9216():
    """K7's second conv at the deepest image level (1024 input channels):
    an implicit GEMM over K = 9 * 1024 (tap-major, then channel, the
    kernel's order) of a relu'd input on an 8x8 plane with SAME padding,
    weights at std fan_in^-0.5 (chip_smoke's draw), held to float64 at K7's
    1e-5 abs + rel."""
    cin, cout, side = 1024, 32, 8
    rng = np.random.default_rng(29)
    x = torch.from_numpy(np.maximum(rng.normal(size=(1, side, side, cin)), 0)
                         .astype(np.float32))
    w = torch.from_numpy(rng.normal(0, (9 * cin) ** -0.5, (3, 3, cin, cout))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[0, dy:dy + side, dx:dx + side].reshape(side * side, cin)
                      for dy in range(3) for dx in range(3)], 1)
    w_k = w.reshape(9 * cin, cout)
    truth = cols.double() @ w_k.double() + b.double()
    got = mma_matmul(cols, w_k) + b
    assert _within(got, truth, TOL, TOL), float((got.double() - truth).abs().max())
    conv = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                      w.double().permute(3, 2, 0, 1), b.double(), padding=1)
    torch.testing.assert_close(conv.permute(0, 2, 3, 1).reshape(-1, cout), truth)


def im2col(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> (B * H * W, 9 C) with SAME zero padding, in the
    implicit GEMM's K order (tap-major, then channel; HWIO's row order). For
    C a multiple of 8 the kernel's per-tap 32-channel steps group the k8
    steps as these flat columns do, and C % 4 != 0 takes the flat steps."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w].reshape(-1, c)
                      for dy in range(3) for dx in range(3)], 1)


def conv_mma(x, w, b, relu: bool):
    """A 3x3 SAME conv as igemm_conv.cuh computes it: the implicit GEMM in
    3xTF32 k8 steps, then + bias (one fp32 rounding) and the optional ReLU."""
    bsz, h, wd, _ = x.shape
    y = mma_matmul(im2col(x), w.reshape(-1, w.shape[-1])) + b
    return (torch.relu(y) if relu else y).reshape(bsz, h, wd, -1)


def _conv_case(rng, cin, cout):
    return (torch.from_numpy(rng.normal(0, min(0.2, (9 * cin) ** -0.5), (3, 3, cin, cout))
                             .astype(np.float32)),
            torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)))


def test_three_tf32_products_hold_the_decoder_chain_tolerance():
    """K6 on a 12 x 12 plane: conv1 32 -> 64, conv2 64 -> 128, conv3 128 ->
    64, each on the previous conv's rounded output (the scratch x1, x2 and
    the staged x3), then the 288 -> 1 head in fp32 (its four parts in the
    plain composition's order). Rounding compounds through the chain; every
    stage is held to the float64 plain decoder at 1e-5 abs + rel."""
    rng = np.random.default_rng(31)
    widths = (32, 64, 128, 64)
    x = torch.from_numpy(rng.normal(size=(1, 12, 12, widths[0])).astype(np.float32))
    convs = [_conv_case(rng, ci, co) for ci, co in zip(widths, widths[1:])]
    w4 = torch.from_numpy(rng.normal(0, sum(widths) ** -0.5, (1, 1, sum(widths), 1))
                          .astype(np.float32))
    b4 = torch.from_numpy(rng.normal(0, 0.1, 1).astype(np.float32))
    acts, truth = [x], [x.double()]
    for w, b in convs:
        acts.append(conv_mma(acts[-1], w, b, True))
        truth.append(conv3x3_plain(truth[-1], w.double(), b.double(), True))
    out, off = b4, 0
    for a in acts:
        out = out + a @ w4[0, 0, off:off + a.shape[-1]]
        off += a.shape[-1]
    want = conv_decoder_plain(*(a.double() for a in (x, *convs[0], *convs[1], *convs[2],
                                                      w4, b4)))
    for i, (a, ref) in enumerate(zip(acts[1:], truth[1:]), 1):
        assert _within(a, ref, TOL, TOL), (i, float((a.double() - ref).abs().max()))
    assert _within(out, want, TOL, TOL), float((out.double() - want).abs().max())


@pytest.mark.parametrize("cin,cout", [(3, 32), (33, 40)])
def test_three_tf32_products_hold_the_conv_tolerance_without_relu(cin, cout):
    """K8 with ``relu=False`` on a 10 x 14 plane at batch 2, Cin 3 and 33
    (the flat-K steps, K padded once): within 1e-5 abs + rel of float64,
    negative outputs included."""
    rng = np.random.default_rng(37 + cin)
    x = torch.from_numpy(rng.normal(size=(2, 10, 14, cin)).astype(np.float32))
    w, b = _conv_case(rng, cin, cout)
    got = conv_mma(x, w, b, False)
    want = conv3x3_plain(x.double(), w.double(), b.double(), False)
    assert bool((want < 0).any())
    assert _within(got, want, TOL, TOL), float((got.double() - want).abs().max())
