"""The port's three conv kernels (K8 conv3x3, K7 conv pair, K6 decoder head)
against the JAX package's Pallas kernels on the same inputs.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in interpret mode (they pick it themselves off a TPU). H = 24 makes the JAX
kernels' ``_band_rows`` pick 8-row bands, so three bands exercise the halos;
one case has H != W. Inputs come from seeded numpy, weights at std
min(0.2, fan_in^-0.5). Tolerance: rtol 1e-5, atol 1e-4, the JAX package's own
(tests/test_decoder_kernel.py:41-42). The backward (:class:`PlainVjp`) is
held to plain autograd.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tomosar2height_tpu.ops.pallas.conv_kernel import pallas_conv3x3  # noqa: E402
from tomosar2height_tpu.ops.pallas.convpair_kernel import fused_conv_pair  # noqa: E402
from tomosar2height_tpu.ops.pallas.decoder_kernel import fused_conv_decoder  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda.conv_kernel import PlainVjp, conv3x3  # noqa: E402
from tomosar2height_tpu_torch.ops.cuda.convpair_kernel import (  # noqa: E402
    conv_pair,
    conv_pair_plain,
)
from tomosar2height_tpu_torch.ops.cuda.decoder_kernel import (  # noqa: E402
    conv_decoder,
    conv_decoder_plain,
)

TOL = dict(rtol=1e-5, atol=1e-4)
SHAPES = [(24, 24), (24, 16)]


def conv_weights(rng, cin, cout, k=3):
    std = min(0.2, (k * k * cin) ** -0.5)
    return (rng.normal(0, std, (k, k, cin, cout)).astype(np.float32),
            rng.normal(0, 0.1, cout).astype(np.float32))


def image(rng, h, w, c, b=2):
    return rng.normal(0, 1, (b, h, w, c)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_matches_jax(h, w, relu):
    rng = np.random.default_rng(0)
    x = image(rng, h, w, 5)
    k, b = conv_weights(rng, 5, 12)
    want = pallas_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), relu=relu)
    got = conv3x3(t(x), t(k), t(b), relu)
    assert got.shape == (2, h, w, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("pool", [False, True])
def test_conv_pair_matches_jax(h, w, pool):
    rng = np.random.default_rng(1)
    x = image(rng, h, w, 3)  # Cin = 3, as the image U-Net's first level
    w1, b1 = conv_weights(rng, 3, 8)
    w2, b2 = conv_weights(rng, 8, 12)
    args = (x, w1, b1, w2, b2)
    want_y, want_p = fused_conv_pair(*map(jnp.asarray, args), pool)
    got_y, got_p = conv_pair(*map(t, args), pool)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    if pool:
        assert got_p.shape == (2, h // 2, w // 2, 12)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    else:
        assert got_p is None and want_p is None


@pytest.mark.parametrize("h,w", SHAPES)
def test_conv_decoder_matches_jax(h, w):
    rng = np.random.default_rng(2)
    x = image(rng, h, w, 4)
    w1, b1 = conv_weights(rng, 4, 8)
    w2, b2 = conv_weights(rng, 8, 12)
    w3, b3 = conv_weights(rng, 12, 8)
    w4, b4 = conv_weights(rng, 4 + 8 + 12 + 8, 2, k=1)
    args = (x, w1, b1, w2, b2, w3, b3, w4, b4)
    want = fused_conv_decoder(*map(jnp.asarray, args))
    got = conv_decoder(*map(t, args))
    assert got.shape == (2, h, w, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_vjp_gives_the_plain_gradients():
    """The kernels' autograd Function: forward from one callable, gradients
    from the plain composition (a stand-in kernel here: off the card there
    is none), equal to plain autograd; outputs without a cotangent and
    inputs that need no gradient are skipped."""
    rng = np.random.default_rng(3)
    args = [t(a).double() for a in (image(rng, 8, 8, 3), *conv_weights(rng, 3, 4),
                                     *conv_weights(rng, 4, 4))]
    for a in args[1:]:
        a.requires_grad_()
    calls = []

    def kernel(*a):
        calls.append(1)
        return conv_pair_plain(*a, True)

    y, p = PlainVjp.apply(kernel, lambda *a: conv_pair_plain(*a, True), *args)
    (y.sum() + (p ** 2).sum()).backward()
    got = [a.grad.clone() for a in args[1:]]
    assert args[0].grad is None and len(calls) == 1
    for a in args[1:]:
        a.grad = None
    y, p = conv_pair_plain(*args, True)
    (y.sum() + (p ** 2).sum()).backward()
    for g, a in zip(got, args[1:]):
        torch.testing.assert_close(g, a.grad, rtol=1e-12, atol=1e-12)

    x = args[0].detach().requires_grad_()
    PlainVjp.apply(conv_decoder_plain, conv_decoder_plain, x, *(
        t(v).double() for v in (*conv_weights(rng, 3, 4), *conv_weights(rng, 4, 4),
                                *conv_weights(rng, 4, 4), *conv_weights(rng, 15, 1, k=1))
    )).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
