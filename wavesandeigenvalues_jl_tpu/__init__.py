"""wavesandeigenvalues_jl_tpu — a JAX sparse-FEM / nonlinear-eigenvalue
framework with the capabilities of WavesAndEigenvalues.jl.

Built from scratch on JAX/XLA: tetrahedral P1/P2/Hermite FEM
assembly of parameterized operator families K + ωC + ω²M + n·e^{-iωτ}Q
for the thermoacoustic Helmholtz equation, a domain-agnostic NLEVP stack
(Householder/MSLP iterations, Beyn contour integration, arbitrary-order
adjoint perturbation + Padé, FTF fitting), APE and 1-D network models,
Bloch-symmetry reduction, shape sensitivities, and mesh/VTK tooling —
with sharded operators, device SpMM, GMRES and block-Thomas solves and
contour-shift batching on GPU device meshes, plus native C++ host
kernels.

Subpackages: ``mesh``, ``fem``, ``models``, ``nlevp``, ``ops``,
``parallel``, ``native``, ``utils`` — see docs/index.md.
"""
from .utils import config  # noqa: F401  (enables x64, defines dtypes)

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access: wavesandeigenvalues_jl_tpu.nlevp etc. work
    # without importing the whole stack at package import
    import importlib
    if name in ("mesh", "fem", "models", "nlevp", "ops", "parallel",
                "native", "utils"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
