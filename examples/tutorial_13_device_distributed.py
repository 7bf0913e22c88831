"""Tutorial 13 — the device compute path and multi-device sharding.

This has no reference counterpart: the reference is single-threaded
CPU-only (SURVEY.md §2.9).  Here the assembled operator family is staged
onto the accelerator as a block-sparse (BSR) tensor, applied to 128-column
panels with the XLA BSR SpMM (one batched matmul over the gathered RHS
block panels, ``ops.device.bsr_spmm_xla``), and row-partitioned over a
device mesh with halo exchange for multi-device SpMV.

Run (8 virtual CPU devices stand in for a multi-GPU host):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      PYTHONPATH=. python examples/tutorial_13_device_distributed.py
"""
import numpy as np

from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
from wavesandeigenvalues_jl_tpu.models import discretize
from wavesandeigenvalues_jl_tpu.ops.device import BsrOperator, bsr_spmm_xla
from wavesandeigenvalues_jl_tpu.ops.reorder import (bandwidth, cuthill_mckee,
                                                    permute_csr)

# ── assemble on host
mesh = rijke_mesh(n_rings=3, nz_cold=30, nz_hot=30)
c = mesh.generate_field(lambda x, y, z: np.where(z < 0, 347.0, 694.0))
L = discretize(mesh, {"Interior": ("interior", ()),
                      "Outlet": ("admittance", ("Y", 1e15))}, c)
L.params["ω"] = 2 * np.pi * 300.0
A = L.assemble({})
print(f"operator: {A.shape[0]} DOF, {A.nnz} nnz")

# ── bandwidth-reduce so BSR blocks are well filled
perm = cuthill_mckee(A)
Ar = permute_csr(A, perm)
print(f"bandwidth: {bandwidth(A)} → {bandwidth(Ar)} after RCM")

# ── device operator: 128×128 blocks on the union sparsity pattern
bsr = BsrOperator.from_csr(Ar, bs=128)
n_blocks = bsr.blocks.shape[0] - 1  # last block is the zero pad
print(f"BSR: {n_blocks} blocks of {bsr.bs}x{bsr.bs}, "
      f"fill {Ar.nnz / (n_blocks * bsr.bs**2):.3f}")

# apply to a 128-RHS panel (the Beyn / block-Krylov shape)
rng = np.random.default_rng(0)
X = (rng.standard_normal((A.shape[0], 128))
     + 1j * rng.standard_normal((A.shape[0], 128))).astype(np.complex64)
f = bsr_spmm_xla(bsr)
Y = np.asarray(f(X))
ref = np.zeros_like(X)
rows = np.repeat(np.arange(A.shape[0]), np.diff(Ar.indptr))
np.add.at(ref, rows, (Ar.data[:, None] * X[Ar.indices]).astype(np.complex64))
err = np.abs(Y - ref).max() / np.abs(ref).max()
print(f"device SpMM vs host reference: rel err {err:.1e}")
assert err < 1e-4  # float32 panels

# ── multi-device: jit one full distributed solver step over a device mesh
# (per-shift assembly × row-partitioned halo-exchange SpMV × psum norms)
import jax
if len(jax.devices()) >= 4 or len(jax.devices("cpu")) >= 4:
    import __graft_entry__ as ge
    ge.dryrun_multichip(4)
    print("4-device sharded solver step: compiled + executed OK")
print("OK")

# ── scaling statements: exact per-iteration communication accounting for
# the composed row-sharded GMRES, and the per-split compute time measured
# on this backend (collective time itself comes from a multi-device trace)
from wavesandeigenvalues_jl_tpu.parallel.scaling import (
    dist_gmres_strong_report, gmres_comm_accounting)
acc = gmres_comm_accounting(n=A.shape[0], P=4, halo=bandwidth(Ar), l=2,
                            restart=20, max_restarts=2)
print(f"per-matvec halo: {acc['ppermute_hops_per_matvec']} ppermute hops, "
      f"{acc['halo_bytes_per_matvec_per_col']} B/col; "
      f"{acc['psums_per_arnoldi_iter']} psums/iter")
rep = dist_gmres_strong_report(Ar, device_counts=(1, 4), l=1, restart=8,
                               max_restarts=1, bs=16)
for r in rep["records"]:
    print(f"  split P={r['n_devices']}: compute efficiency "
          f"{r['compute_efficiency']:.2f}")
print("OK scaling")
