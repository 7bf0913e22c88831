"""Performance benchmark — prints ONE JSON line.

Headline: sustained sparse operator application throughput (nnz/s) of
the assembled thermoacoustic Helmholtz operator on the 57k-DOF octosplit
Rijke operator, as the XLA BSR SpMM (``ops.device.bsr_spmm_xla``) on a
128-column panel (the Beyn / block-Arnoldi panel shape) after
Cuthill–McKee reordering.  m applies run chained inside one device
program (normalized power iteration) and the timing ends in
``block_until_ready``.  ``vs_baseline`` compares against the reference's
compute model: single-core host CSR products of the same operator on the
same panel (WavesAndEigenvalues.jl runs all SpMV through single-threaded
SuiteSparse/Julia kernels; the reference publishes no wall-clock numbers
— BASELINE.md).

Also reported: a block-size sweep on the 7,259-DOF operator, the HBM
roofline share against the device's data-sheet bandwidth (``HBM_BW``),
an asserted batched shifted GMRES + refinement smoke, and the 7,259-DOF
``mslp`` with the host engine and the fused slab device engine.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

#: peak device-memory bandwidth by JAX ``device_kind`` [bytes/s]
#: (NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s)
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

#: the driver captures a 2,000-char output tail; the contract line must
#: stay under this
CONTRACT_LINE_LIMIT = 1800

NRHS = 128


def peak_hbm_bw(kind: str) -> float:
    """Data-sheet memory bandwidth of ``kind``; an unknown device is an
    error, not a default."""
    if kind not in HBM_BW:
        raise KeyError(f"no peak bandwidth on record for device {kind!r}")
    return HBM_BW[kind]


def passive_operator(octo: bool = False):
    """Passive flagship Rijke-tube Helmholtz family on the 7,259-DOF
    generated cylinder (``octo``: its 57,210-DOF octosplit child)."""
    from __graft_entry__ import flagship_dscrp, flagship_speed_of_sound
    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu.mesh.refine import octosplit
    from wavesandeigenvalues_jl_tpu.models import discretize

    mesh = rijke_mesh(n_rings=4, nz_cold=58, nz_hot=58)
    if octo:
        mesh = octosplit(mesh)
    return discretize(mesh, flagship_dscrp(active=False),
                      flagship_speed_of_sound(mesh))


def time_bsr(bsr, X, reps=20):
    """Compile + time the XLA BSR SpMM: ``reps`` normalized applies
    chained in one jitted scan, best of 3.  Returns (s/apply, apply)."""
    import jax
    import jax.numpy as jnp
    from wavesandeigenvalues_jl_tpu.ops.device import bsr_spmm_xla

    n = X.shape[0]
    Xp = np.zeros((bsr.n, NRHS), np.complex64)
    Xp[:n] = X
    Xb = Xp.reshape(-1, bsr.bs, NRHS)
    panels = (jnp.asarray(np.ascontiguousarray(Xb.real), jnp.float32),
              jnp.asarray(np.ascontiguousarray(Xb.imag), jnp.float32))
    f = bsr_spmm_xla(bsr)
    apply_split = f.apply_split

    @jax.jit
    def chain(xr, xi):
        def body(carry, _):
            yr, yi = apply_split(*carry)
            s = 1.0 / jnp.maximum(
                jnp.sqrt(jnp.sum(yr * yr) + jnp.sum(yi * yi)), 1e-30)
            return (yr * s, yi * s), 0
        (yr, yi), _ = jax.lax.scan(body, (xr, xi), None, length=reps)
        return yr, yi

    jax.block_until_ready(chain(*panels))
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(*panels))
        dt = min(dt, (time.perf_counter() - t0) / reps)
    return dt, f


def spmm_record(A, bs, X, bw):
    """Time one BSR block size on CSR ``A`` and check it against the host
    CSR product."""
    import scipy.sparse as sp
    from wavesandeigenvalues_jl_tpu.ops.device import BsrOperator

    bsr = BsrOperator.from_csr(A, bs=bs)
    dt, f = time_bsr(bsr, X)
    Ah = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    Yh = Ah @ X
    rel = float(np.linalg.norm(f(X)[:A.shape[0]] - Yh) / np.linalg.norm(Yh))
    if rel >= 5e-5:
        raise RuntimeError(f"BSR SpMM wrong at bs={bs}: rel err {rel}")
    # device-memory traffic per apply: block planes stream once, the RHS
    # panel is read once and the output written once (f32 planes)
    hbm_bytes = 8.0 * (bsr.blocks.size + bsr.n * NRHS * 2)
    return {
        "bs": bs, "dim": int(A.shape[0]), "nnz": int(A.nnz),
        "ms_per_apply": dt * 1e3,
        "nnz_per_s": A.nnz * NRHS / dt,
        "fill": bsr.fill_ratio,
        "hbm_bytes": hbm_bytes,
        "achieved_GBps": hbm_bytes / dt / 1e9,
        "roofline_frac": (hbm_bytes / bw) / dt,
        "rel_err_vs_host": rel,
    }, Ah


def host_nnz_per_s(Ah, X) -> float:
    """Single-core host CSR panel product rate (the reference's model)."""
    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < 1.0:
        Ah @ X
        reps += 1
    return Ah.nnz * NRHS / ((time.perf_counter() - t0) / reps)


def smoke_shifted_batch():
    """Batched shifted GMRES + refinement, asserted against a direct
    solve."""
    from __graft_entry__ import _flagship_family
    from wavesandeigenvalues_jl_tpu.ops.gmres import solve_shifted_batch
    from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
    from wavesandeigenvalues_jl_tpu.ops.refine import refine

    Lp = _flagship_family()
    zsm = 2 * np.pi * np.array([250 + 5j, 350 + 5j])
    rng = np.random.default_rng(1)
    Bm = (rng.standard_normal((2, Lp.size))
          + 1j * rng.standard_normal((2, Lp.size)))
    t0 = time.perf_counter()
    Xm, _res = solve_shifted_batch(Lp, zsm, Bm, tol=1e-7)
    t_batch = time.perf_counter() - t0
    A0 = Lp(complex(zsm[0]))
    x_ref = factorize(A0).solve(Bm[0])
    err_raw = float(np.linalg.norm(Xm[0] - x_ref) / np.linalg.norm(x_ref))
    x1, _hist = refine(
        A0, Bm[0],
        lambda b: solve_shifted_batch(Lp, zsm[:1], b[None], tol=1e-7)[0][0])
    err_ref = float(np.linalg.norm(x1 - x_ref) / np.linalg.norm(x_ref))
    if err_ref >= 1e-8:
        raise RuntimeError(f"refined device solve off: {err_ref}")
    return {"shifted_batch_wall_s": t_batch, "err_raw_device": err_raw,
            "err_after_refinement": err_ref}


def eigensolve_7k():
    """mslp on the 7,259-DOF passive operator: host sparse-LU engine vs
    the fused slab-direct device engine (warm)."""
    from wavesandeigenvalues_jl_tpu.nlevp import mslp
    from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend

    L = passive_operator()
    z0 = 272 * 2 * np.pi
    t0 = time.perf_counter()
    sol_h, its_h, _f = mslp(L, z0, maxiter=30, tol=1e-11)
    t_host = time.perf_counter() - t0
    prev = set_solve_backend("device")
    try:
        mslp(L, z0, maxiter=30, tol=1e-11)                 # compile
        t0 = time.perf_counter()
        sol_d, its_d, _f = mslp(L, z0, maxiter=30, tol=1e-11)
        t_dev = time.perf_counter() - t0
    finally:
        set_solve_backend(prev)
    return {"dim": int(L.size), "wall_s_host": t_host, "iters_host": its_h,
            "wall_s_device": t_dev, "iters_device": its_d,
            "device_abs_err_vs_host_rad_s": abs(sol_d.params["ω"]
                                                - sol_h.params["ω"]),
            "path": "fused_slab"}


def _round(x, sig=6):
    return float(f"{x:.{sig}g}") if isinstance(x, float) else x


def _short_err(s, n=160):
    return s if not isinstance(s, str) or len(s) <= n else s[:n] + "…"


def headline(kind, large, best_small, vs_base, eig7k, smoke) -> dict:
    """The contract line's record: the headline metric plus slim extras
    (full detail goes to bench_detail.json)."""
    if "nnz_per_s" in large:
        metric = "helmholtz_57k_spmm128_sustained_nnz_per_s"
        value = large["nnz_per_s"]
    else:
        metric = "helmholtz_operator_spmm128_nnz_per_s"
        value = best_small.get("nnz_per_s")
    slim = lambda rec, keys: {k: _short_err(_round(rec[k])) for k in keys
                              if k in rec}
    return {
        "metric": metric,
        "value": _round(value),
        "unit": "nnz/s",
        "vs_baseline": _round(vs_base),
        "extra": {
            "device_kind": kind,
            "kernel": "xla_bsr",
            "hbm_roofline": slim(large, (
                "bs", "dim", "nnz_per_s", "achieved_GBps", "roofline_frac",
                "rel_err_vs_host", "error")),
            "small_op": slim(best_small, ("bs", "nnz_per_s",
                                          "roofline_frac", "error")),
            "eigensolve_7k": slim(eig7k, (
                "dim", "wall_s_host", "wall_s_device",
                "device_abs_err_vs_host_rad_s", "error")),
            "device_smoke": slim(smoke, ("err_after_refinement", "error")),
        },
    }


def check_contract_line(line: str) -> str:
    """Refuse to print a contract line the driver would truncate."""
    if len(line) >= CONTRACT_LINE_LIMIT:
        raise ValueError(f"bench contract line {len(line)} chars >= "
                         f"{CONTRACT_LINE_LIMIT} — move detail into "
                         "bench_detail.json")
    return line


def _section(fn):
    try:
        return fn()
    except Exception as e:  # surface, don't hide: the line must print
        return {"error": f"{type(e).__name__}: {e}"}


def main():
    import jax

    from wavesandeigenvalues_jl_tpu.ops.reorder import (cuthill_mckee,
                                                        permute_csr)

    kind = jax.devices()[0].device_kind
    bw = peak_hbm_bw(kind)
    rng = np.random.default_rng(0)

    def reordered(octo):
        L = passive_operator(octo)
        L.params["ω"] = 2 * np.pi * 300.0
        A = L.assemble({})
        return permute_csr(A, cuthill_mckee(A))

    # --- block-size sweep on the 7,259-DOF operator ----------------------
    Ar = reordered(False)
    X = (rng.standard_normal((Ar.shape[0], NRHS))
         + 1j * rng.standard_normal((Ar.shape[0], NRHS))).astype(np.complex64)
    sweep = {bs: _section(lambda: spmm_record(Ar, bs, X, bw)[0])
             for bs in (32, 64, 128)}
    ok = [r for r in sweep.values() if "nnz_per_s" in r]
    best_small = max(ok, key=lambda r: r["nnz_per_s"]) if ok else {
        "error": "every block size failed"}

    # --- headline: the 57k-DOF operator, working set far above L2 --------
    def large_section():
        Al = reordered(True)
        Xl = (rng.standard_normal((Al.shape[0], NRHS))
              + 1j * rng.standard_normal((Al.shape[0], NRHS))
              ).astype(np.complex64)
        best, best_Ah = None, None
        for bs in (32, 64):
            rec, Ah = spmm_record(Al, bs, Xl, bw)
            if best is None or rec["nnz_per_s"] > best["nnz_per_s"]:
                best, best_Ah = rec, Ah
        best["host_nnz_per_s"] = host_nnz_per_s(best_Ah, Xl)
        return best

    large = _section(large_section)
    if "nnz_per_s" in large:
        vs_base = large["nnz_per_s"] / large["host_nnz_per_s"]
    else:
        import scipy.sparse as sp
        Ah = sp.csr_matrix((Ar.data, Ar.indices, Ar.indptr), shape=Ar.shape)
        vs_base = (best_small.get("nnz_per_s", 0.0)
                   / host_nnz_per_s(Ah, X))

    smoke = _section(smoke_shifted_batch)
    eig7k = _section(eigensolve_7k)

    result = headline(kind, large, best_small, vs_base, eig7k, smoke)
    detail = {"bs_sweep": sweep, "large_operator": large,
              "device_smoke": smoke, "eigensolve_7k": eig7k,
              "headline": result}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_detail.json"), "w") as f:
        json.dump(detail, f, indent=1)
    print(check_contract_line(json.dumps(result)))


if __name__ == "__main__":
    main()
