"""Tutorial 15 — matrix-free contour integration with a geometric
two-grid preconditioner.

The reference's global Beyn solver factorizes L(z) with UMFPACK at every
contour node (/root/reference/src/NLEVP/beyn.jl:62-74).  The matrix-free
device path never materializes a factor: every node becomes a batch of GMRES
panel solves over the union-pattern value stack, preconditioned by one
multiplicative two-grid cycle whose coarse level is a coarser octosplit
ancestor of the same mesh — the coarse operator is the SAME symbolic
family discretized coarse, inverted once per shift, applied as a single
matmul.

This scales the contour solver past the dense-node regime (see
examples/scale_beyn.py for the big-mesh driver) while reproducing host
(LU) Beyn eigenvalues.

Run:
  JAX_PLATFORMS=cpu PYTHONPATH=. python examples/tutorial_15_matrixfree_beyn.py
"""
import time

import numpy as np

from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
from wavesandeigenvalues_jl_tpu.mesh.refine import octosplit, p1_prolongation
from wavesandeigenvalues_jl_tpu.models import discretize
from wavesandeigenvalues_jl_tpu.nlevp.solvers import beyn
from wavesandeigenvalues_jl_tpu.ops.panel_solve import CoarseGrid
from wavesandeigenvalues_jl_tpu.parallel.dist_beyn import beyn_batched

# ── the mesh hierarchy: solve on `fine`, precondition from `coarse`
coarse = rijke_mesh(n_rings=2, nz_cold=12, nz_hot=12)
P = p1_prolongation(coarse)          # P1 interpolation coarse → fine
fine = octosplit(coarse)

dscrp = {"Interior": ("interior", ()), "Outlet": ("admittance", ("Y", 1e15))}


def c_field(m):
    return m.generate_field(lambda x, y, z: np.where(z < 0, 347.0, 694.0))


Lc = discretize(coarse, dscrp, c_field(coarse))
Lf = discretize(fine, dscrp, c_field(fine))
print(f"fine {Lf.size} DOF / coarse {Lc.size} DOF")

# ── matrix-free device Beyn: GMRES panels + two-grid preconditioner
Gamma = 2 * np.pi * np.array([150 - 5j, 800 - 5j, 800 + 5j, 150 + 5j])
t0 = time.time()
Om_mf, P_mf = beyn_batched(Lf, Gamma, l=6, N=24, rtol=1e-12, dense=False,
                           coarse=CoarseGrid(Lc, P))
t_mf = time.time() - t0
print("matrix-free modes [Hz]:", np.sort(Om_mf.real) / 2 / np.pi,
      f"({t_mf:.1f}s)")

# ── host (sparse LU) Beyn for comparison
t0 = time.time()
Om_h, P_h = beyn(Lf, Gamma, l=6, N=24, rtol=1e-12)
t_h = time.time() - t0
print("host-LU     modes [Hz]:", np.sort(Om_h.real) / 2 / np.pi,
      f"({t_h:.1f}s)")

match = np.max(np.abs(np.sort_complex(Om_mf) - np.sort_complex(Om_h)))
print(f"max |Δω| between the two paths: {match / 2 / np.pi:.2e} Hz")
assert match / 2 / np.pi < 1e-6
