"""Weak-scaling measurement harness for the distributed SpMV.

BASELINE.json asks for "nnz/s scaling efficiency reported at 1 chip,
1 host, and N ≥ 2 hosts".  The reference has no distributed layer to
compare against (SURVEY §2.9); this harness measures OUR row-sharded
halo-exchange SpMV at increasing device counts with a FIXED per-device
workload (weak scaling) and emits one record per device count:

    {"n_devices", "rows", "nnz", "wall_s_per_apply", "nnz_per_s",
     "nnz_per_s_per_device", "efficiency_vs_1"}

On the virtual CPU mesh the numbers validate the *harness* only; on real
devices the same call produces the reportable figures.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from ..ops.sparse import CSR
from .dist_spmv import make_dist_spmv
from .partition import partition_rows


def _banded_operator(n: int, band: int = 31, seed: int = 0) -> CSR:
    """FEM-like banded complex operator (bandwidth ~ a CMK-reordered
    tetrahedral P1 stiffness)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-(band // 2), band // 2 + 1)
    rows_l, cols_l, vals_l = [], [], []
    for k in offs:
        m = n - abs(k)
        r = np.arange(max(0, -k), max(0, -k) + m)
        vals = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        if k == 0:
            vals += band  # diagonally dominant-ish
        rows_l.append(r)
        cols_l.append(r + k)
        vals_l.append(vals)
    return CSR.from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                        np.concatenate(vals_l), (n, n))


def spmv_scaling_report(device_counts: Sequence[int] = (1, 2, 4, 8),
                        rows_per_device: int = 4096, band: int = 31,
                        reps: int = 50, verify: bool = True) -> List[dict]:
    """Weak-scaling records for the distributed halo-exchange SpMV.

    Each device count P gets its own (P·rows_per_device)-row operator and
    its own P-device mesh; throughput is the best-of-3 amortized apply
    time.  ``efficiency_vs_1`` is per-device throughput normalized by the
    1-device figure (the ≥70% multi-host criterion of BASELINE.json)."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    out: List[dict] = []
    base = None
    for P in device_counts:
        if P > len(devs):
            continue
        n = P * rows_per_device
        A = _banded_operator(n, band=band)
        part = partition_rows(A, P, reorder=False)
        mesh = Mesh(np.array(devs[:P]), ("row",))
        spmv, shard, unshard = make_dist_spmv(part, mesh)
        rng = np.random.default_rng(1)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        xs = shard(x)
        y = spmv(xs)
        jax.block_until_ready(y)
        if verify:
            err = np.linalg.norm(unshard(y) - A @ x) / np.linalg.norm(A @ x)
            assert err < 1e-10, f"dist SpMV wrong at P={P}: {err}"
        dt = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                y = spmv(xs)
            jax.block_until_ready(y)
            dt = min(dt, (time.perf_counter() - t0) / reps)
        rec = {
            "n_devices": int(P),
            "rows": int(n),
            "nnz": int(A.nnz),
            "wall_s_per_apply": float(dt),
            "nnz_per_s": float(A.nnz / dt),
            "nnz_per_s_per_device": float(A.nnz / dt / P),
        }
        if base is None:
            # efficiency is relative to the SMALLEST measured device count
            # (== 1 when 1 ∈ device_counts); the baseline is recorded per
            # record so the normalization is never ambiguous
            base = rec["nnz_per_s_per_device"]
            base_P = int(P)
        rec["baseline_n_devices"] = base_P
        rec["efficiency_vs_smallest"] = float(
            rec["nnz_per_s_per_device"] / base)
        if base_P == 1:
            rec["efficiency_vs_1"] = rec["efficiency_vs_smallest"]
        out.append(rec)
    return out


def dist_gmres_scaling_report(device_counts: Sequence[int] = (1, 2, 4, 8),
                              rows_per_device: int = 4096, band: int = 31,
                              l: int = 2, restart: int = 20,
                              max_restarts: int = 2,
                              bs: int = 32) -> List[dict]:
    """Weak-scaling records for the COMPOSED row-sharded GMRES solve —
    the thing that actually runs on a pod (VERDICT r2 #9: the SpMV-only
    harness said nothing about the full solve).

    Work per device count is pinned deterministic (tol=0 → exactly
    ``max_restarts`` restart cycles of ``restart`` Arnoldi steps per
    column), so the efficiency figure measures the communication/compute
    balance of the composed solve, not convergence luck.  Throughput is
    reported as preconditioned-matvec nnz/s (matvecs = l·restarts·
    (restart+2))."""
    import jax
    from jax.sharding import Mesh

    from ..ops.sparse import StackedOperator
    from .dist_solve import make_dist_gmres
    from .partition import partition_stack

    devs = jax.devices()
    out: List[dict] = []
    base = None
    base_P = None
    for P in device_counts:
        if P > len(devs):
            continue
        n = P * rows_per_device
        A = _banded_operator(n, band=band)
        stack = StackedOperator.from_csrs([A])
        part = partition_stack(stack, P)
        mesh = Mesh(np.array(devs[:P]), ("row",))
        solve = make_dist_gmres(part, mesh, bs=bs, tol=0.0,
                                restart=restart,
                                max_restarts=max_restarts)
        coeffs = np.ones((1, 1), np.complex128)
        rng = np.random.default_rng(2)
        B = (rng.standard_normal((1, l, n))
             + 1j * rng.standard_normal((1, l, n)))
        X, res = solve(coeffs, B)          # compile + warm
        t0 = time.perf_counter()
        X, res = solve(coeffs, B)
        dt = time.perf_counter() - t0
        matvecs = l * max_restarts * (restart + 2)
        rec = {
            "n_devices": int(P),
            "rows": int(n),
            "nnz": int(A.nnz),
            "wall_s_per_solve": float(dt),
            "matvec_nnz_per_s": float(A.nnz * matvecs / dt),
            "matvec_nnz_per_s_per_device": float(A.nnz * matvecs / dt / P),
        }
        if base is None:
            base = rec["matvec_nnz_per_s_per_device"]
            base_P = int(P)
        rec["baseline_n_devices"] = base_P
        rec["efficiency_vs_smallest"] = float(
            rec["matvec_nnz_per_s_per_device"] / base)
        if base_P == 1:
            rec["efficiency_vs_1"] = rec["efficiency_vs_smallest"]
        out.append(rec)
    return out


def gmres_comm_accounting(n: int, P: int, halo: int, l: int, restart: int,
                          max_restarts: int, itemsize: int = 16) -> dict:
    """Per-iteration communication accounting for the row-sharded GMRES
    (VERDICT r3 #4: make the scaling number interpretable).

    The composed solve (:func:`..parallel.dist_solve.make_dist_gmres`)
    communicates, per Arnoldi iteration and per RHS column:

    * halo exchange: 2·⌈halo/m⌉ nearest-neighbor ``ppermute`` hops of
      ``halo`` rows each (dist_spmv.halo_exchange) = the matvec's only
      communication — volume independent of P;
    * CGS2: 2 ``psum`` reductions of the (restart+1)-long projection
      vector + 2 scalar norm psums;

    with ``itemsize``-byte complex payloads.  Counts are exact properties
    of the algorithm, not measurements."""
    m = n // P
    hops = 0 if (P == 1 or halo == 0) else 2 * -(-halo // m)
    iters = max_restarts * (restart + 2)
    return {
        "rows_per_device": m,
        "halo_rows": int(halo),
        "ppermute_hops_per_matvec": hops,
        "halo_bytes_per_matvec_per_col": 2 * halo * itemsize,
        "psums_per_arnoldi_iter": 4,
        "psum_bytes_per_arnoldi_iter": (2 * (restart + 1) + 2) * itemsize,
        "arnoldi_iters_per_solve": iters,
        "cols": l,
        "comm_bytes_per_solve": l * iters * (
            2 * halo * itemsize + (2 * (restart + 1) + 2) * itemsize),
    }


def dist_gmres_strong_report(A: CSR, device_counts: Sequence[int]
                             = (1, 2, 4, 8, 16, 32),
                             l: int = 2, restart: int = 20,
                             max_restarts: int = 2, bs: int = 32) -> dict:
    """Strong-scaling COMPUTE measurement for the row-sharded GMRES on a
    FIXED operator: the problem split P ways, per-device compute shrinks
    while the per-iteration overhead floor stays.

    For every P the per-device workload is emulated by the leading
    ⌈n/P⌉-row principal submatrix of the (bandwidth-reduced) operator —
    the same rows-per-device block the real partition would own — solved
    at P=1 on the CURRENT backend:

        compute_efficiency(P) = (t_iter(n)/P) / t_iter(n/P)

    Communication is not modelled: collective time comes from a trace of
    a real multi-device run.  The exact per-iteration communication
    counts are in ``gmres_comm_accounting`` per record."""
    import jax
    import scipy.sparse as sp
    from jax.sharding import Mesh

    from ..ops.reorder import bandwidth
    from ..ops.sparse import StackedOperator
    from .dist_solve import make_dist_gmres
    from .partition import partition_stack

    n = A.shape[0]
    halo = int(bandwidth(A))
    As = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    mesh = Mesh(np.array(jax.devices()[:1]), ("row",))
    coeffs = np.ones((1, 1), np.complex128)
    rng = np.random.default_rng(2)
    iters = max_restarts * (restart + 2)

    t_iter = {}
    for P in device_counts:
        m = -(-n // P)
        Am = As[:m, :m].tocsr()
        stack = StackedOperator.from_csrs([
            CSR(Am.indptr, Am.indices, Am.data, (m, m))])
        part = partition_stack(stack, 1)
        solve = make_dist_gmres(part, mesh, bs=bs, tol=0.0,
                                restart=restart, max_restarts=max_restarts)
        B = (rng.standard_normal((1, l, m))
             + 1j * rng.standard_normal((1, l, m)))
        solve(coeffs, B)                    # compile + warm
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            solve(coeffs, B)
            best = min(best, time.perf_counter() - t0)
        t_iter[P] = best / iters

    t1 = t_iter[min(device_counts)] * min(device_counts)  # t_iter at P=1
    records = []
    for P in device_counts:
        records.append({
            "n_devices": int(P),
            "rows_per_device": int(-(-n // P)),
            "t_iter_measured_s": float(t_iter[P]),
            "compute_efficiency": float(min((t1 / P) / t_iter[P], 1.0)),
            "gmres_comm_accounting": gmres_comm_accounting(
                n, P, halo, l, restart, max_restarts),
        })
    return {
        "n_rows": int(n), "nnz": int(A.nnz), "halo_rows": halo,
        "restart": restart, "l": l,
        "backend": jax.devices()[0].platform,
        "records": records,
    }


__all__ = ["spmv_scaling_report", "dist_gmres_scaling_report",
           "gmres_comm_accounting", "dist_gmres_strong_report"]
