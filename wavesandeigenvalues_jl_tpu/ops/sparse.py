"""Host-side sparse containers and the stacked-operator layout.

The reference stores each term of an operator family as its own
``SparseMatrixCSC`` and evaluates ``L(z) = Σ_k c_k(z)·A_k`` by summing k
sparse matrices per call (/root/reference/src/NLEVP/LinOpFam.jl:482-529).
That is hostile to accelerators: k scatter-adds with distinct sparsity
patterns per evaluation.

The layout used here instead *unifies* all terms onto the union
sparsity pattern once (`StackedOperator`): a single shared CSR structure with
a value tensor ``V[K, nnz]``.  Evaluating the family for any parameter values
is then a tiny dense contraction ``data = c @ V`` (one matmul when
batched over many evaluation points) followed by ONE SpMV / one scatter into
a dense buffer.  Derivatives w.r.t. parameters only change ``c`` — the
structure is static, so everything jits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..utils.config import CDTYPE, IDTYPE


# ---------------------------------------------------------------------------
# COO helpers


def coo_sum_duplicates(rows, cols, vals, shape):
    """Sum duplicate (i,j) entries; drop exact zeros. Returns sorted COO.

    Offloads to the native C++ kernel (native/host_kernels.cpp) for large
    assemblies; numpy sort/reduceat fallback below."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=CDTYPE)
    if rows.size == 0:
        return rows.astype(IDTYPE), cols.astype(IDTYPE), vals
    if rows.size >= 1 << 15 and vals.dtype == np.complex128:
        from .. import native
        out = native.coo_dedup(rows, cols, vals, n_cols=int(shape[1]))
        if out is not None:
            r, c, v = out
            return r.astype(IDTYPE), c.astype(IDTYPE), v
    n_cols = shape[1]
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    vals = vals[order]
    uniq, start = np.unique(key, return_index=True)
    sums = np.add.reduceat(vals, start)
    r = (uniq // n_cols).astype(IDTYPE)
    c = (uniq % n_cols).astype(IDTYPE)
    keep = sums != 0
    return r[keep], c[keep], sums[keep]


@dataclass
class CSR:
    """Compressed sparse row matrix (host, numpy)."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "CSR":
        rows, cols, vals = coo_sum_duplicates(rows, cols, vals, shape)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr, cols.astype(IDTYPE), vals.astype(CDTYPE), tuple(shape))

    @classmethod
    def from_dense(cls, A) -> "CSR":
        A = np.asarray(A)
        rows, cols = np.nonzero(A)
        return cls.from_coo(rows, cols, A[rows, cols], A.shape)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def to_dense(self) -> np.ndarray:
        A = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        A[rows, self.indices] = self.data
        return A

    def to_coo(self):
        rows = np.repeat(np.arange(self.shape[0], dtype=IDTYPE),
                         np.diff(self.indptr))
        return rows, self.indices.copy(), self.data.copy()

    def matvec(self, x: np.ndarray) -> np.ndarray:
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        prod = self.data * x[self.indices]
        out = np.zeros(self.shape[0], dtype=np.result_type(self.data, x))
        np.add.at(out, rows, prod)
        return out

    def __matmul__(self, x):
        x = np.asarray(x)
        if x.ndim == 1:
            return self.matvec(x)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        out = np.zeros((self.shape[0], x.shape[1]), dtype=np.result_type(self.data, x))
        np.add.at(out, rows, self.data[:, None] * x[self.indices, :])
        return out

    def conj_transpose(self) -> "CSR":
        rows, cols, vals = self.to_coo()
        return CSR.from_coo(cols, rows, np.conj(vals),
                            (self.shape[1], self.shape[0]))

    def scaled(self, a) -> "CSR":
        return CSR(self.indptr, self.indices, self.data * a, self.shape)

    def __add__(self, other: "CSR") -> "CSR":
        if self.shape != other.shape:
            raise ValueError("shape mismatch")
        ra, ca, va = self.to_coo()
        rb, cb, vb = other.to_coo()
        return CSR.from_coo(np.concatenate([ra, rb]),
                            np.concatenate([ca, cb]),
                            np.concatenate([va, vb]), self.shape)

    def __sub__(self, other: "CSR") -> "CSR":
        return self + other.scaled(-1.0)

    def norm(self) -> float:
        return float(np.linalg.norm(self.data))


# ---------------------------------------------------------------------------
# stacked union-pattern operator


def union_pattern(mats: Sequence[CSR]):
    """Union sparsity pattern of CSR matrices sharing a shape.

    Returns ``(indptr, indices, slots)`` where ``slots[k]`` maps the k-th
    matrix's nnz entries into positions of the union value array.
    """
    shape = mats[0].shape
    n_cols = shape[1]
    keys = []
    for m in mats:
        rows = np.repeat(np.arange(shape[0], dtype=np.int64), np.diff(m.indptr))
        keys.append(rows * n_cols + m.indices.astype(np.int64))
    all_keys = np.unique(np.concatenate(keys)) if keys else np.array([], np.int64)
    rows = (all_keys // n_cols).astype(IDTYPE)
    cols = (all_keys % n_cols).astype(IDTYPE)
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    slots = [np.searchsorted(all_keys, k).astype(np.int64) for k in keys]
    return indptr, cols, slots


@dataclass
class StackedOperator:
    """K sparse matrices on a shared (union) CSR pattern.

    ``values[k]`` holds term k's data scattered onto the union pattern, so
    that for coefficient vector ``c``: ``L(c) = CSR(indptr, indices, c @ values)``.
    """

    indptr: np.ndarray
    indices: np.ndarray
    values: np.ndarray  # [K, nnz]
    shape: Tuple[int, int]

    @classmethod
    def from_csrs(cls, mats: Sequence[CSR]) -> "StackedOperator":
        indptr, indices, slots = union_pattern(mats)
        nnz = len(indices)
        values = np.zeros((len(mats), nnz), dtype=CDTYPE)
        for k, (m, slot) in enumerate(zip(mats, slots)):
            values[k, slot] = m.data
        return cls(indptr, indices, values, mats[0].shape)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def assemble(self, coeffs) -> CSR:
        data = np.asarray(coeffs, dtype=CDTYPE) @ self.values
        return CSR(self.indptr, self.indices, data, self.shape)

    def assemble_dense(self, coeffs) -> np.ndarray:
        return self.assemble(coeffs).to_dense()

    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0], dtype=IDTYPE),
                         np.diff(self.indptr))


# ---------------------------------------------------------------------------
# ELL packing (device-friendly fixed-width rows)


def csr_to_ell(indptr, indices, n_cols: int, width: int | None = None):
    """Pack CSR structure into padded ELL: per-row fixed-width column ids and
    a slot→nnz gather map (padding points at an extra zero slot)."""
    counts = np.diff(indptr)
    n_rows = len(counts)
    nnz = len(indices)
    w = int(width if width is not None else (counts.max() if n_rows else 0))
    if counts.max(initial=0) > w:
        raise ValueError("ELL width too small")
    cols = np.zeros((n_rows, w), dtype=IDTYPE)
    gather = np.full((n_rows, w), nnz, dtype=np.int64)  # pad slot
    mask = np.zeros((n_rows, w), dtype=bool)
    # vectorized ragged→padded scatter: entry k of row i goes to slot
    # (i, k − indptr[i]) — no Python row loop (setup at 10⁵–10⁶ DOF is
    # exactly the regime the distributed layer exists for)
    ridx = np.repeat(np.arange(n_rows), counts)
    pos = np.arange(nnz) - np.repeat(indptr[:-1], counts)
    cols[ridx, pos] = indices
    gather[ridx, pos] = np.arange(nnz)
    mask[ridx, pos] = True
    return cols, gather, mask


__all__ = ["CSR", "StackedOperator", "coo_sum_duplicates", "union_pattern",
           "csr_to_ell"]
