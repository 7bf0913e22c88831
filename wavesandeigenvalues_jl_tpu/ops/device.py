"""Device (XLA) sparse operator layouts and kernels.

Two complementary layouts:

* **ELL** (padded fixed-width rows): SpMV as gather + row-reduce — one fused
  XLA kernel, bandwidth-bound; the default on every backend.  Complex data
  is carried as complex128 (:func:`..utils.config.device_complex_dtype`)
  or as a float64 (real, imag) pair for the refinement path.
* **BSR** (dense [bs×bs] blocks on a block-sparse row structure): SpMM as
  a batch of dense block matmuls (:func:`bsr_spmm_xla`).

The stacked-family evaluation (coefficients × value-stack) is one matmul
``data[B, nnz] = C[B, K] @ V[K, nnz]`` when batched over B evaluation points
(contour nodes, parameter sweeps).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import device_complex_dtype
from .sparse import CSR, StackedOperator, csr_to_ell


@dataclass
class EllOperator:
    """Padded fixed-width-row sparse structure on device."""

    cols: jnp.ndarray     # [n_rows, w] int32 column ids (pad: 0)
    gather: jnp.ndarray   # [n_rows, w] int64 slot -> nnz index (pad: nnz)
    mask: jnp.ndarray     # [n_rows, w] bool
    n_cols: int
    nnz: int

    @classmethod
    def from_csr(cls, A: CSR, width: Optional[int] = None) -> "EllOperator":
        cols, gather, mask = csr_to_ell(A.indptr, A.indices, A.shape[1], width)
        return cls(jnp.asarray(cols), jnp.asarray(gather), jnp.asarray(mask),
                   A.shape[1], A.nnz)

    def pack(self, data) -> jnp.ndarray:
        """nnz data vector -> padded [n_rows, w] ELL values."""
        data = jnp.asarray(data)
        padded = jnp.concatenate([data, jnp.zeros(1, data.dtype)])
        return padded[self.gather]

    def matvec(self, vals: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """y = A x with packed ELL values [n_rows, w]."""
        return jnp.sum(vals * x[self.cols], axis=1)

    def matmat(self, vals: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
        """Y = A X for X [n_cols, k]."""
        return jnp.sum(vals[:, :, None] * X[self.cols, :], axis=1)


def spmv_ell(vals, cols, x):
    """Functional ELL SpMV (jit/vmap-friendly)."""
    return jnp.sum(vals * x[cols], axis=1)


# ---------------------------------------------------------------------------
# float64-pair complex arithmetic


def cpx_split(z):
    z = np.asarray(z)
    return jnp.asarray(z.real, jnp.float64), jnp.asarray(z.imag, jnp.float64)


def cpx_spmv_pair(vr, vi, cols, xr, xi):
    """Complex SpMV on (real, imag) float64 pairs."""
    ar = jnp.sum(vr * xr[cols] - vi * xi[cols], axis=1)
    ai = jnp.sum(vr * xi[cols] + vi * xr[cols], axis=1)
    return ar, ai


# ---------------------------------------------------------------------------
# device-side stacked family


class DeviceStackedOperator:
    """Device mirror of :class:`..ops.sparse.StackedOperator`: shared ELL
    structure + value stack [K, nnz]; evaluation for a batch of coefficient
    vectors is one matmul + one pack."""

    def __init__(self, stack: StackedOperator, dtype=None,
                 width: Optional[int] = None):
        self.dtype = dtype or device_complex_dtype()
        self.ell = EllOperator.from_csr(
            CSR(stack.indptr, stack.indices,
                np.zeros(len(stack.indices), np.complex128), stack.shape),
            width)
        self.values = jnp.asarray(stack.values.astype(self.dtype))  # [K, nnz]
        self.shape = stack.shape
        self.row_ids = jnp.asarray(stack.row_ids(), jnp.int32)      # [nnz]
        self.col_ids = jnp.asarray(stack.indices, jnp.int32)        # [nnz]

    def data(self, coeffs) -> jnp.ndarray:
        """nnz data for one coefficient vector (or [B, nnz] for a batch)."""
        c = jnp.asarray(coeffs, self.values.dtype)
        return c @ self.values

    def matvec(self, coeffs, x):
        vals = self.ell.pack(self.data(coeffs))
        return self.ell.matvec(vals, jnp.asarray(x, self.dtype))

    def dense(self, coeffs) -> jnp.ndarray:
        """Dense assembly on device (for batched LU solves): scatter the nnz
        data into a [d, d] buffer (or [B, d, d] for batched coeffs)."""
        data = self.data(coeffs)
        d = self.shape[0]
        if data.ndim == 1:
            buf = jnp.zeros((d, d), self.dtype)
            return buf.at[self.row_ids, self.col_ids].set(data)
        B = data.shape[0]
        buf = jnp.zeros((B, d, d), self.dtype)
        return buf.at[:, self.row_ids, self.col_ids].set(data)

    def __repr__(self):
        return (f"DeviceStackedOperator(shape={self.shape}, "
                f"K={self.values.shape[0]}, nnz={self.values.shape[1]}, "
                f"dtype={self.dtype})")


# ---------------------------------------------------------------------------
# BSR layout for the batched-matmul SpMM


@dataclass
class BsrOperator:
    """Block-sparse rows: dense [bs, bs] blocks; per block-row a padded list
    of block-column indices (pad: repeat last with zero block)."""

    blocks: np.ndarray      # [n_blocks_total, bs, bs]
    block_cols: np.ndarray  # [n_block_rows, max_blocks] int32
    block_mask: np.ndarray  # [n_block_rows, max_blocks] bool
    bs: int
    n: int                  # padded dimension

    @classmethod
    def from_csr(cls, A: CSR, bs: int = 128) -> "BsrOperator":
        n = ((A.shape[0] + bs - 1) // bs) * bs
        nbr = n // bs
        rows, cols, vals = A.to_coo()
        br, bc = rows // bs, cols // bs
        key = br.astype(np.int64) * nbr + bc
        order = np.argsort(key)
        key_s, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
        uniq, start = np.unique(key_s, return_index=True)
        boundaries = np.append(start, len(key_s))
        n_blocks = len(uniq)
        blocks = np.zeros((n_blocks + 1, bs, bs), dtype=vals.dtype)  # +1 zero pad
        ub_r = (uniq // nbr).astype(np.int64)
        ub_c = (uniq % nbr).astype(np.int64)
        for b in range(n_blocks):
            s, e = boundaries[b], boundaries[b + 1]
            blocks[b][rows[s:e] - ub_r[b] * bs, cols[s:e] - ub_c[b] * bs] = vals[s:e]
        counts = np.bincount(ub_r, minlength=nbr)
        maxb = int(counts.max()) if n_blocks else 1
        block_cols = np.zeros((nbr, maxb), np.int32)
        block_ids = np.full((nbr, maxb), n_blocks, np.int64)  # pad: zero block
        block_mask = np.zeros((nbr, maxb), bool)
        fill = np.zeros(nbr, np.int64)
        for b in range(n_blocks):
            r = ub_r[b]
            block_cols[r, fill[r]] = ub_c[b]
            block_ids[r, fill[r]] = b
            block_mask[r, fill[r]] = True
            fill[r] += 1
        # order blocks array in row-major scan so the kernel's per-row block
        # list indexes into a contiguous [nbr, maxb, bs, bs] tensor
        gathered = blocks[block_ids]  # [nbr, maxb, bs, bs]
        return cls(gathered, block_cols, block_mask, bs, n)

    @property
    def fill_ratio(self) -> float:
        nz = np.count_nonzero(self.blocks)
        return nz / self.blocks.size

    def matvec_reference(self, x: np.ndarray) -> np.ndarray:
        """Host reference BSR SpMV for testing."""
        xp = np.zeros(self.n, dtype=x.dtype)
        xp[:len(x)] = x
        xb = xp.reshape(-1, self.bs)
        y = np.einsum("rkij,rkj->ri", self.blocks, xb[self.block_cols])
        return y.reshape(-1)[:len(x)]


def bsr_spmm_xla(bsr: BsrOperator):
    """BSR SpMM Y = A X as one XLA batched matmul over the gathered RHS
    block panels, complex64 data as (re, im) float32 planes.  Returns
    ``apply(X) -> Y`` on host arrays; ``apply.apply_split(Xr, Xi)`` is the
    jitted plane-level product on [nb, bs, r] panels."""
    b = bsr.blocks.astype(np.complex64)
    blocks_re = jnp.asarray(b.real)
    blocks_im = jnp.asarray(b.imag)
    cols = jnp.asarray(bsr.block_cols, jnp.int32)
    bs, n = bsr.bs, bsr.n

    @jax.jit
    def apply_split(Xr, Xi):
        hi = jax.lax.Precision.HIGHEST
        ein = lambda a, b: jnp.einsum("rkij,rkjm->rim", a, b, precision=hi)
        Xgr = Xr[cols]
        Xgi = Xi[cols]
        Yr = ein(blocks_re, Xgr) - ein(blocks_im, Xgi)
        Yi = ein(blocks_re, Xgi) + ein(blocks_im, Xgr)
        return Yr, Yi

    def apply(X):
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]
        nl, r = X.shape
        Xp = np.zeros((n, r), np.complex64)
        Xp[:nl] = X
        Xb = Xp.reshape(-1, bs, r)
        Yr, Yi = apply_split(
            jnp.asarray(np.ascontiguousarray(Xb.real), jnp.float32),
            jnp.asarray(np.ascontiguousarray(Xb.imag), jnp.float32))
        return (np.asarray(Yr) + 1j * np.asarray(Yi)).reshape(-1, r)[:nl]

    apply.apply_split = apply_split
    return apply


__all__ = ["EllOperator", "spmv_ell", "DeviceStackedOperator", "BsrOperator",
           "bsr_spmm_xla", "cpx_split", "cpx_spmv_pair"]
