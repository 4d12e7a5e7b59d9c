"""Iterative sparse linear solvers over the framework's SpMM kernels.

Conjugate gradient and Jacobi, expressed with ``lax.while_loop`` so a whole
solve compiles into one XLA program (no per-iteration host sync). The
``spmm`` argument is any closure over a prepared strategy operand, so a
solve runs identically on one device or a row-sharded mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["conjugate_gradient", "jacobi", "cgls", "SolveResult"]


class SolveResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array
    residual_norm: jax.Array


def conjugate_gradient(spmm: Callable[[jax.Array], jax.Array], b: jax.Array,
                       *, x0=None, tol: float = 1e-10,
                       max_iter: int = 1000,
                       preconditioner: Callable[[jax.Array], jax.Array]
                       | None = None) -> SolveResult:
    """(Preconditioned) CG for SPD systems ``A x = b``.

    ``b`` may be ``(n,)`` or ``(n, k)`` — a fat right-hand side runs k
    solves in lockstep, the SpMM-native formulation.
    ``preconditioner`` applies ``M^-1`` (e.g. ``lambda r: r * inv_diag``
    for Jacobi preconditioning); identity when omitted.
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    precond = preconditioner or (lambda r: r)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - spmm(x)
    z = precond(r)
    p = z
    rz = jnp.sum(r * z, axis=0)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(
        jnp.sum(b * b, axis=0), 1.0
    )

    def cond(state):
        _, r, _, _, i = state
        return jnp.logical_and(
            jnp.any(jnp.sum(r * r, axis=0) > tol2), i < max_iter
        )

    def body(state):
        x, r, p, rz, i = state
        ap = spmm(p)
        denom = jnp.sum(p * ap, axis=0)
        alpha = jnp.where(denom > 0, rz / jnp.where(denom == 0, 1, denom), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = jnp.sum(r * z, axis=0)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1, rz), 0.0)
        p = z + beta * p
        return x, r, p, rz_new, i + 1

    x, r, _, rz, iters = jax.lax.while_loop(
        cond, body, (x, r, p, rz, jnp.asarray(0))
    )
    norm = jnp.sqrt(jnp.sum(r * r))
    if squeeze:
        x = x[:, 0]
    return SolveResult(x, iters, norm)


def cgls(spmm: Callable[[jax.Array], jax.Array],
         spmm_t: Callable[[jax.Array], jax.Array], b: jax.Array, *,
         tol: float = 1e-10, max_iter: int = 1000) -> SolveResult:
    """CGLS: least-squares ``min ||A x - b||`` for general (rectangular)
    sparse ``A``, using the forward operator and its transpose — the pair
    ``ops/autodiff.py::make_spmm`` prepares. ``b`` is ``(m,)`` or ``(m, k)``.
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    s = spmm_t(b)
    x = jnp.zeros_like(s)
    r = b
    p = s
    gamma = jnp.sum(s * s, axis=0)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(
        jnp.sum(s * s, axis=0), 1.0
    )

    def cond(state):
        _, _, _, gamma, i = state
        return jnp.logical_and(jnp.any(gamma > tol2), i < max_iter)

    def body(state):
        x, r, p, gamma, i = state
        q = spmm(p)
        denom = jnp.sum(q * q, axis=0)
        alpha = jnp.where(denom > 0, gamma / jnp.where(denom == 0, 1, denom),
                          0.0)
        x = x + alpha * p
        r = r - alpha * q
        s = spmm_t(r)
        gamma_new = jnp.sum(s * s, axis=0)
        beta = jnp.where(gamma > 0,
                         gamma_new / jnp.where(gamma == 0, 1, gamma), 0.0)
        p = s + beta * p
        return x, r, p, gamma_new, i + 1

    x, r, _, gamma, iters = jax.lax.while_loop(
        cond, body, (x, r, p, gamma, jnp.asarray(0))
    )
    norm = jnp.sqrt(jnp.sum(r * r))
    if squeeze:
        x = x[:, 0]
    return SolveResult(x, iters, norm)


def jacobi(spmm: Callable[[jax.Array], jax.Array], diag: jax.Array,
           b: jax.Array, *, tol: float = 1e-10,
           max_iter: int = 2000) -> SolveResult:
    """Jacobi iteration ``x <- x + D^-1 (b - A x)`` for diagonally dominant
    systems. ``diag`` is the matrix diagonal ``(n,)``."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    inv_d = jnp.where(diag != 0, 1.0 / jnp.where(diag == 0, 1, diag), 0.0)
    x = jnp.zeros_like(b)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(
        jnp.sum(b * b), 1.0
    )

    def cond(state):
        _, res2, i = state
        return jnp.logical_and(res2 > tol2, i < max_iter)

    def body(state):
        x, _, i = state
        r = b - spmm(x)
        x = x + inv_d[:, None] * r
        return x, jnp.sum(r * r), i + 1

    x, res2, iters = jax.lax.while_loop(
        cond, body, (x, jnp.asarray(jnp.inf, b.dtype), jnp.asarray(0))
    )
    if squeeze:
        x = x[:, 0]
    return SolveResult(x, iters, jnp.sqrt(res2))
