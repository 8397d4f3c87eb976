"""Port conformance, transcendentals: ``repro_torch.kernels.xla_math``
against XLA's own ``jnp.exp``/``jnp.log``/``jnp.log2``/``jnp.tanh``/
``jax.nn.sigmoid`` and XLA's contracted ``a*b + c``, bit for bit.

The port repeats XLA:CPU's expansions (constants, clamps, op order, the
fused multiply-adds its LLVM backend forms, flush-to-zero), so every
output must equal the reference's: tolerance 0, NaN where the reference
gives NaN.  The fused multiply-adds exist only on a host with FMA, so the
``xla_fma`` fixture checks first that XLA contracts on this host and
skips, with that reason, where it does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import xla_math as xm

N = 333_335            # per kind; 3N > 10^6, odd: XLA's scalar tail too


def _inputs(seed):
    """Normal, wide-range log-uniform and uniform inputs, N of each."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0.0, 4.0, N),
        rng.normal(0.0, 1.0, N) * 10.0 ** rng.uniform(-8, 2, N),
        rng.uniform(-100.0, 100.0, N)]).astype(np.float32)


EDGES = np.array([
    0.0, -0.0, np.inf, -np.inf, np.nan,
    1e-40, -1e-40, 2.0 ** -149, 2.0 ** -126, -(2.0 ** -126), 3.4e38,
    -87.8, -87.80001, 88.8, 88.80001,          # exp's input clamp
    -87.33655, -87.5, 88.72283, 88.7228,       # exp under- and overflow
    7.998811, -7.998811, 8.0,                  # tanh's clamp
    0.0004, 0.00039999998, 20.0, -20.0, 19.999998,
    0.70710677, 0.7071068, 1.0, -1.0, 0.5], np.float32)


@pytest.fixture(scope="module")
def xla_fma():
    """Skip where XLA on this host does not contract a*b + c."""
    a, b, c = (np.float32(1 + 2.0 ** -12),) * 2 + (np.float32(-1),)
    fused = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    if fused == (a * b) + c:
        pytest.skip("XLA does not fuse multiply-adds on this host (no FMA)")


def _same(port: torch.Tensor, ref) -> int:
    """Count of outputs that differ in bits (NaN equals NaN)."""
    p, r = port.numpy(), np.asarray(ref)
    both_nan = np.isnan(p) & np.isnan(r)
    return int(np.count_nonzero(~both_nan & (p.view(np.uint32)
                                             != r.view(np.uint32))))


@pytest.mark.parametrize("name", ["exp", "tanh", "sigmoid", "log", "log2"])
def test_bit_exact_against_xla(xla_fma, name):
    port, ref = {"exp": (xm.xla_exp, jnp.exp),
                 "tanh": (xm.xla_tanh, jnp.tanh),
                 "sigmoid": (xm.xla_sigmoid, jax.nn.sigmoid),
                 "log": (xm.xla_log, jnp.log),
                 "log2": (xm.xla_log2, jnp.log2)}[name]
    x = _inputs(["exp", "tanh", "sigmoid", "log", "log2"].index(name))
    if name.startswith("log"):                 # mostly positive, 60 decades
        rng = np.random.default_rng(1)
        x = (np.abs(x) * 10.0 ** rng.uniform(-30, 30, x.size)
             ).astype(np.float32)
    x = np.concatenate([x, EDGES])
    want = jax.jit(ref)(x)
    assert _same(port(torch.from_numpy(x)), want) == 0
    got_edges = port(torch.from_numpy(EDGES))
    assert _same(got_edges, jax.jit(ref)(EDGES)) == 0


def test_edge_values(xla_fma):
    """The special values the expansions produce (as XLA:CPU does)."""
    t = torch.tensor
    assert xm.xla_exp(t([-87.5, 88.8, -np.inf, np.inf])).tolist() == [
        0.0, np.inf, 0.0, np.inf]              # flushed / overflowed
    assert xm.xla_log(t([0.0, 1e-40, np.inf])).tolist() == [
        -np.inf, -np.inf, np.inf]              # a denormal counts as zero
    assert np.isnan(xm.xla_log(t([-1.0, np.nan])).numpy()).all()
    assert xm.xla_tanh(t([1e-40, 25.0, -np.inf])).tolist() == [
        pytest.approx(1e-40, rel=1e-6), 1.0, -1.0]
    assert xm.xla_sigmoid(t([-90.0, 0.0])).tolist() == [0.0, 0.5]


def test_fma_equals_xla_contraction(xla_fma):
    """``fma`` (float64 with round-to-odd) against XLA's contracted
    a*b + c on 10^6 random triples over six decades, plus cases where a
    plain float64 sum would round twice."""
    rng = np.random.default_rng(7)
    a, b, c = (rng.normal(0, 1, 10 ** 6).astype(np.float32)
               * np.float32(10.0) ** rng.integers(-3, 4, 10 ** 6
                                                  ).astype(np.float32)
               for _ in range(3))
    # 3·(1 + 2^-23) lies exactly halfway between two floats; ∓2^-60
    # decides the rounding, which a float64 sum would drop.
    a = np.concatenate([a, [3.0, 3.0]]).astype(np.float32)
    b = np.concatenate([b, [1 + 2.0 ** -23] * 2]).astype(np.float32)
    c = np.concatenate([c, [-(2.0 ** -60), 2.0 ** -60]]).astype(np.float32)
    want = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    got = xm.fma(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c))
    assert _same(got, want) == 0
    assert got[-2:].tolist() == [3 + 2.0 ** -22, 3 + 2.0 ** -21]
    unfused = torch.from_numpy(a) * torch.from_numpy(b) + torch.from_numpy(c)
    assert _same(unfused, want) > 0.05 * a.size    # XLA really contracts


def test_ftz_flushes_to_signed_zero():
    x = torch.tensor([1e-39, -1e-39, 2.0 ** -126, -3.0, 0.0])
    y = xm.ftz(x)
    assert y.tolist() == [0.0, 0.0, 2.0 ** -126, -3.0, 0.0]
    assert torch.signbit(y).tolist() == [False, True, False, True, False]
