"""XLA:CPU's float32 transcendentals, op for op, as PyTorch elementwise ops.

The JAX reference evaluates σ, tanh, exp and log2 through XLA's own
expansions, not through a libm: on the CPU, ``jnp.tanh`` is a rational
approximation, ``jnp.exp`` a Cephes polynomial with 2^n built in the
exponent bits, ``jnp.log`` a Cephes polynomial on the mantissa,
``jnp.log2`` that log times ``1.44269502f`` (XLA rewrites the division by
the constant ``log(2)`` into a multiplication by its reciprocal), and
``jax.nn.sigmoid`` ``1 / (1 + exp(-x))`` on that exp.  Each rounds
differently from PyTorch's and CUDA's own functions, and one ulp flips a
rounded 12-bit feature or Q0.15 hidden code.  The functions here repeat
XLA's expansions with the same constants, clamps, op order and bit
tricks, so the port rounds exactly where the reference does.

Where they come from.  ``XLA_FLAGS=--xla_dump_to=DIR`` on the JAX package
dumps each compiled fusion as ``*.ir-with-opt.ll`` and as an object file
(``*.o``).  The IR gives the op sequence and the constants (printed as
doubles; each is a float32).  The object file (``objdump -d``) shows
what the LLVM backend made of it: XLA compiles with
``AllowFPOpFusion=Fast``, so on a host with FMA every ``fmul`` whose only
use is an ``fadd``/``fsub`` becomes one fused multiply-add, in the 8-wide
vector body and in the scalar tail alike.  Those places are ``fma``
below; every other product rounds on its own.  XLA:CPU also runs with
flush-to-zero and denormals-are-zero: results below 2^-126 become a
signed zero and denormal inputs count as zero (``ftz``).

Exactness against ``jnp`` holds on hosts with FMA (x86-64 with FMA3,
which XLA targets natively); ``tests/test_torch_xla_math.py`` checks it
bit for bit on 2·10^6 random inputs and the edge cases.  The CUDA kernels
use the same sequences from ``csrc/xla_math.cuh``.

``fma`` is the exact float32 fused multiply-add in PyTorch: the product
of two float32 values is exact in float64, the float64 sum is rounded to
odd (its TwoSum error decides the last bit), and rounding that to float32
is then correctly rounded — a plain float64 sum would round twice.

Gradients.  The expansions read bits through integer views, which cut
an autograd graph, and the gradient of a rational approximation is not
the derivative of the function it approximates.  So ``xla_sigmoid``,
``xla_tanh`` and ``fma`` (where an operand needs a gradient) are
``torch.autograd.Function``s: the forward is the exact expansion, bit for
bit, and the backward is JAX's own derivative rule — ``g·(s·(1−s))`` for
``lax.logistic``, ``(g + g·t)·(1−t)`` for ``tanh`` (transposed, as
``jax.grad`` evaluates it: u = g·(1−t), then u + u·t with the product
fused), ``(g·b, g·a, g)`` for ``a·b + c`` — so a gradient through the
ΔGRU's gates is what ``jax.grad`` computes.  ``xla_exp`` and ``xla_log``
have no gradient (nothing trained differentiates them).
"""
from __future__ import annotations

import numpy as np
import torch

_TINY = 2.0 ** -126          # smallest normal float32


def _c(bits: int) -> float:
    """The float32 with these bits, as a Python float (exact)."""
    return float(np.array(bits, np.uint32).view(np.float32))


# jnp.tanh: XLA's EmitFastTanh (odd rational, clamped input).
_TANH_SMALL = _c(0x39D1B717)      # 0.0004: tanh(x) = x below this
_TANH_CLAMP = _c(0x40FFF644)      # 7.99881172
_TANH_NUM = tuple(map(_c, (0xA59F25C0, 0x2A61337E, 0xAEBD37FF, 0x335C0041,
                           0x3779434A, 0x3A270DED, 0x3BA059DC)))
_TANH_DEN = tuple(map(_c, (0x35A0D3D8, 0x38F895D6, 0x3B14AA05, 0x3BA059DD)))
_TANH_SAT = 20.0                  # |x| >= 20: ±1

# jnp.exp: Cephes exp (polynomial_approximations.cc GenerateVF32Exp).
_EXP_LO, _EXP_HI = _c(0xC2AF999A), _c(0x42B1999A)    # -87.8, 88.8
_LOG2E = _c(0x3FB8AA3B)
_EXP_C1, _EXP_C2 = _c(0x3F318000), _c(0xB95E8083)    # ln 2 = C1 + C2
_EXP_P = tuple(map(_c, (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1,
                        0x3E2AAAAA))) + (0.5,)

# jnp.log: Cephes log (GenerateVF32Log); log2 multiplies by 1/ln 2.
_SQRTHF = _c(0x3F3504F3)
_LOG_P = tuple(map(_c, (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F,
                        0x3E11E9BF, 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC,
                        0x3EAAAAAA)))
_LOG_Q1, _LOG_Q2 = _c(0xB95E8083), _c(0x3F318000)
INV_LN2 = _LOG2E                  # 1.44269502f, the constant of jnp.log2


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 denormals to a zero of the same sign, as x86's FTZ
    and DAZ modes (and CUDA's ``.ftz``) do."""
    return x * (x.abs() >= _TINY)


def fma(a, b, c) -> torch.Tensor:
    """Exact float32 ``a * b + c`` with one rounding, then flushed.

    Operands are float32 tensors or Python floats (rounded to float32
    first); at least one is a tensor.  Evaluated in float64 with
    round-to-odd.  Differentiable (``(g·b, g·a, g)``) where a tensor
    operand needs a gradient.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (a, b, c)):
        return _FusedMulAdd.apply(a, b, c)
    return _fma(a, b, c)


def _fma(a, b, c) -> torch.Tensor:
    """``fma``'s exact evaluation (no gradient)."""
    a, b, c = (t.double() if isinstance(t, torch.Tensor) else
               float(np.float32(t)) for t in (a, b, c))
    p = a * b                      # exact: 24 + 24 significant bits
    s = p + c
    p_part = s - c                 # TwoSum: e is exactly (p + c) - s
    e = (p - p_part) + (c - (s - p_part))
    # Round to odd: truncate s toward zero (one step back where s was
    # rounded away from zero), then set the last bit if the sum was
    # inexact.  A NaN error (an infinite operand) changes nothing.
    toward_zero = (e * s) < 0
    bits = (s.view(torch.int64) - toward_zero.long()) | (e.abs() > 0)
    return ftz(bits.view(torch.float64).to(torch.float32))


def _clamp(x, lo: float, hi: float):
    """min(max(x, lo), hi) that keeps NaN, as XLA's clamp."""
    x = torch.where(x < lo, torch.full_like(x, lo), x)
    return torch.where(x > hi, torch.full_like(x, hi), x)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` on XLA:CPU, float32."""
    x = _clamp(x, _EXP_LO, _EXP_HI)
    n = _clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    x = fma(n, -_EXP_C1, x)
    x = fma(n, -_EXP_C2, x)
    p0, p1, p2, p3, p4, p5 = _EXP_P
    z = fma(x, p0, p1)
    for p in (p2, p3, p4, p5):
        z = fma(z, x, p)
    z = fma(z, x * x, x) + 1.0
    n_int = torch.where(torch.isnan(n), torch.zeros_like(n), n).to(
        torch.int32)
    pow2 = torch.bitwise_left_shift(n_int + 127, 23).view(torch.float32)
    return ftz(z * pow2)


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` on XLA:CPU: ``1 / (1 + exp(-x))``.  A true
    division by a tensor (PyTorch on CUDA would turn a division by a
    host scalar into a reciprocal multiply).  Differentiable:
    ``lax.logistic``'s rule, ``g·(s·(1−s))``."""
    return _Sigmoid.apply(x)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    d = xla_exp(-x) + 1.0
    return ftz(torch.ones_like(d) / d)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` on XLA:CPU, float32.  Differentiable: JAX's rule,
    ``(g + g·t)·(1−t)`` (1 − tanh² on the rounded t), as ``jax.grad``
    evaluates it under jit."""
    return _Tanh.apply(x)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    c = _clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = c * c
    num = fma(x2, _TANH_NUM[0], _TANH_NUM[1])
    for k in _TANH_NUM[2:]:
        num = fma(x2, num, k)
    num = c * num
    den = fma(x2, _TANH_DEN[0], _TANH_DEN[1])
    for k in _TANH_DEN[2:]:
        den = fma(x2, den, k)
    r = torch.where(a < _TANH_SMALL, x, num / den)
    return torch.where(a >= _TANH_SAT, torch.ones_like(x).copysign(x), r)


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = _sigmoid(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1.0 - s))


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        t = _tanh(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        # The transpose of the rule's linear map: u = g·(1−t), then
        # u + u·t, its product fused as XLA:CPU fuses it under jit.
        t, = ctx.saved_tensors
        u = g * (1.0 - t)
        return _fma(u, t, u)


class _FusedMulAdd(torch.autograd.Function):
    """``fma`` with the derivative of ``a * b + c``; a Python float
    operand gets no gradient, a broadcast one its summed gradient."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(*(t if isinstance(t, torch.Tensor) else None
                                for t in (a, b)))
        ctx.scalars = tuple(None if isinstance(t, torch.Tensor) else t
                            for t in (a, b))
        ctx.shapes = tuple(t.shape if isinstance(t, torch.Tensor) else None
                           for t in (a, b, c))
        return _fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = (t if t is not None else s
                for t, s in zip(ctx.saved_tensors, ctx.scalars))
        grads = (lambda: g * b, lambda: g * a, lambda: g)
        return tuple(d().sum_to_size(shape) if need else None
                     for d, need, shape in zip(grads, ctx.needs_input_grad,
                                               ctx.shapes))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` on XLA:CPU, float32 (denormal inputs count as zero)."""
    x = ftz(x)
    invalid = ~(x > 0)                                   # x <= 0 or NaN
    t = torch.where(x > _TINY, x, torch.full_like(x, _TINY))
    bits = t.view(torch.int32)
    e = (torch.bitwise_right_shift(bits, 23) - 127).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [.5, 1)
    low = m < _SQRTHF
    zero = torch.zeros_like(m)
    xm = (m - 1.0) + torch.where(low, m, zero)
    e = e - torch.where(low, torch.ones_like(m), zero)
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = fma(fma(xm, p[0], p[1]), xm, p[2])
    y1 = fma(fma(xm, p[3], p[4]), xm, p[5])
    y2 = fma(fma(xm, p[6], p[7]), xm, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    r = fma(x2, -0.5, xm) + y
    r = fma(e, _LOG_Q2, r)
    r = torch.where(invalid, torch.full_like(r, float("nan")), r)
    r = torch.where(x == 0, torch.full_like(r, float("-inf")), r)
    return torch.where(x == float("inf"), x, r)


def xla_log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` on XLA:CPU: ``log(x) * 1.44269502f``."""
    return xla_log(x) * INV_LN2
