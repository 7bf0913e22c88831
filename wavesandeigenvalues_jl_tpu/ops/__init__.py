from .gmres import block_jacobi, gmres, solve_shifted_batch
from .linsolve import (DenseLU, Factorization, SingularMatrixError, SparseLU,
                       factorize, factorize_with_fallback)
from .sparse import CSR, StackedOperator, coo_sum_duplicates, csr_to_ell

__all__ = ["CSR", "StackedOperator", "coo_sum_duplicates", "csr_to_ell",
           "DenseLU", "SparseLU", "Factorization", "SingularMatrixError",
           "factorize", "factorize_with_fallback",
           "gmres", "block_jacobi", "solve_shifted_batch"]
