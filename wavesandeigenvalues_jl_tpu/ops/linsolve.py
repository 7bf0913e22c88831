"""Shifted linear solves: the framework's replacement for UMFPACK.

The reference hands every shifted system to UMFPACK's sparse LU
(SparseArrays.lu) — e.g. Arnoldi inner solves (Householder.jl:100), Beyn
quadrature (beyn.jl:62-74), perturbation recurrences (perturbation.jl:385).

Here the workhorse is dense blocked LU executed by XLA on the device,
which for the moderate FEM dimensions of this domain (10³–10⁵ DOF after
Bloch reduction / subspace projection) beats scalar sparse factorizations on
accelerator hardware, and *batches* over contour shifts.  A matrix-free
GMRES path (see :mod:`.gmres`) covers the large row-partitioned regime.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import scipy.linalg as sla

from ..utils.config import CDTYPE
from .sparse import CSR


class Factorization:
    """Abstract factorization supporting direct and conj-transpose solves."""

    def solve(self, b, trans: str = "N"):
        raise NotImplementedError

    @property
    def ok(self) -> bool:
        return True


class DenseLU(Factorization):
    """Dense partial-pivot LU (LAPACK on host, XLA on device)."""

    def __init__(self, A: np.ndarray):
        A = np.asarray(A, dtype=CDTYPE)
        self.n = A.shape[0]
        self.lu, self.piv = sla.lu_factor(A, check_finite=False)
        self._ok = bool(np.all(np.isfinite(self.lu)))
        if self._ok:
            # exact zero pivot => singular (reference maps this to the
            # SingularException flag, Householder.jl:145-148)
            self._ok = bool(np.all(np.abs(np.diag(self.lu)) > 0))

    @property
    def ok(self) -> bool:
        return self._ok

    def solve(self, b, trans: str = "N"):
        t = {"N": 0, "T": 1, "H": 2}[trans]
        return sla.lu_solve((self.lu, self.piv), np.asarray(b, dtype=CDTYPE),
                            trans=t, check_finite=False)


class DenseQRLstsq(Factorization):
    """Least-squares (pivoted QR/SVD) fallback for exactly singular systems.

    The reference factorizes the (by construction singular) L(0,0) of the
    perturbation recurrence with ``lu(·, check=false)`` and falls back to a
    sparse QR when LU fails (perturbation.jl:329-332, 385-388); this is the
    equivalent minimum-norm solve."""

    def __init__(self, A: np.ndarray):
        self.A = np.asarray(A, dtype=CDTYPE)

    def solve(self, b, trans: str = "N"):
        A = self.A
        if trans == "T":
            A = A.T
        elif trans == "H":
            A = A.conj().T
        x, *_ = sla.lstsq(A, np.asarray(b, dtype=CDTYPE), check_finite=False,
                          lapack_driver="gelsd")
        return x


class SparseLU(Factorization):
    """Sparse LU (SuperLU) for large FEM systems — the direct counterpart
    of the reference's UMFPACK factorization (SparseArrays.lu), used on
    host for matrices too large to densify profitably."""

    def __init__(self, A: CSR):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        M = sp.csr_matrix((A.data.astype(CDTYPE), A.indices, A.indptr),
                          shape=A.shape).tocsc()
        self._ok = True
        try:
            self.F = spla.splu(M)
            u = self.F.U.diagonal()
            self._ok = bool(np.all(np.isfinite(u)) and np.all(u != 0))
        except RuntimeError:
            self._ok = False
            self.F = None

    @property
    def ok(self) -> bool:
        return self._ok

    def solve(self, b, trans: str = "N"):
        return self.F.solve(np.asarray(b, dtype=CDTYPE), trans=trans)


#: below this dimension dense LAPACK LU beats SuperLU's symbolic overhead
SPARSE_LU_MIN_DIM = 600


def factorize(A: Union[CSR, np.ndarray], check: bool = False,
              backend: str | None = None) -> Factorization:
    """Factorize for repeated shifted solves (the UMFPACK role,
    Householder.jl:100-101).  ``backend`` overrides the session default
    (``utils.config.solve_backend()``): 'host' (scipy) or
    'device'/'device_lu'/'device_gmres' (XLA LU / jitted GMRES with
    mixed-precision refinement — see :mod:`.device_solve`)."""
    from ..utils.config import solve_backend
    backend = backend or solve_backend()
    if backend != "host":
        from .device_solve import device_factorize
        F = device_factorize(A, backend)
        if check and not F.ok:
            raise SingularMatrixError(
                "device LU factorization failed (singular matrix)")
        return F
    if isinstance(A, CSR):
        if A.shape[0] >= SPARSE_LU_MIN_DIM:
            F = SparseLU(A)
            if F.ok:
                return F
        A = A.to_dense()
    F = DenseLU(A)
    if check and not F.ok:
        raise SingularMatrixError("LU factorization failed (singular matrix)")
    return F


def factorize_with_fallback(A: Union[CSR, np.ndarray],
                            backend: str | None = None) -> Factorization:
    """LU if it exists, else least-squares QR (the reference's
    lu-then-qr strategy for the singular L(0,0), perturbation.jl:329-332).
    On a device backend a failed device LU falls back to the host path."""
    from ..utils.config import solve_backend
    backend = backend or solve_backend()
    if backend != "host":
        from .device_solve import device_factorize
        F = device_factorize(A, backend)
        if F.ok:
            return F
    if isinstance(A, CSR):
        if A.shape[0] >= SPARSE_LU_MIN_DIM:
            F = SparseLU(A)
            if F.ok:
                return F
        A = A.to_dense()
    F = DenseLU(A)
    if F.ok:
        return F
    return DenseQRLstsq(A)


class SingularMatrixError(np.linalg.LinAlgError):
    pass


def solve(A, b, trans: str = "N"):
    return factorize(A).solve(b, trans)


__all__ = ["Factorization", "DenseLU", "SparseLU", "factorize",
           "factorize_with_fallback", "solve", "SingularMatrixError"]
