"""Block-tridiagonal (Thomas) forward+backward substitution.

Role: the inner solve of the fused slab local NLEVP solver
(:mod:`..nlevp.fused_slab`).  The operator is factorized ONCE per Newton
step by a block-Thomas scan, which precomputes per slab

    W_i  = Dt_i⁻¹ L_i        (forward coupling)
    C_i  = Dt_i⁻¹ U_i        (backward coupling)

so every subsequent solve is the pure recursion

    y_i = Dt_i⁻¹ b_i − W_i y_{i−1}          (forward,  i = 0..m−1)
    x_i = y_i − C_i x_{i+1}                 (backward, i = m−1..0)

— 2m sequential [1,s]×[s,s] complex products per side.

Layout contract (row-vector convention, complex64):

* ``WT``, ``CT``  [m, sides, s, s] — Wᵀ_i and Cᵀ_i;
* ``bt``          [m, sides, s]    — Dt⁻¹-pre-applied RHS, slab layout;
* output x        [m, sides, s]    — slab layout solution.

Reference counterpart: UMFPACK triangular backsolves inside the local
solvers' shift-invert iteration (Householder.jl:100-101).
"""
from __future__ import annotations


def slab_thomas(WT, CT, bt):
    """The recursion as two ``lax.scan`` loops (one batched [sides,s]×
    [sides,s,s] product per slab and direction)."""
    import jax
    import jax.numpy as jnp

    def sweep(prev, xs):
        B, b = xs
        y = b - jnp.einsum("bk,bkj->bj", prev, B,
                           precision=jax.lax.Precision.HIGHEST)
        return y, y

    z = jnp.zeros(bt.shape[1:], bt.dtype)
    _, Y = jax.lax.scan(sweep, z, (WT, bt))
    _, X = jax.lax.scan(sweep, z, (CT, Y), reverse=True)
    return X


__all__ = ["slab_thomas"]
