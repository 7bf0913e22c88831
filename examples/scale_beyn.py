"""Big-mesh end-to-end scale run: matrix-free device Beyn on an
octosplit-refined Rijke mesh.

Octosplits the reference's Rijke_mm.msh ``--nsplit`` times (×2 →
216,320 tets / 42.5k P1 DOF), assembles the passive Helmholtz family,
and solves the passive modes with the matrix-free device Beyn.  The
default backend is the block-tridiagonal SLAB direct solver
(ops/slab_solve.py): all contour-node factorizations run as batched
dense sweeps — the device re-design of the reference's per-node
UMFPACK loop (beyn.jl:62-74).  ``--method gmres`` selects the
multigrid-preconditioned iterative path instead (then the coarse level
hierarchy comes from the original 1006-DOF mesh via composed P1
prolongations).

Eigenpair acceptance is residual-verified (VERDICT r2 #2): per-mode
sparse residuals ‖L(ω)v‖/(‖L‖‖v‖) are computed, reported in SCALE.json
and candidates above ``--res-tol`` are dropped — no silent spurious
modes.  ``--host-check`` additionally runs the same contour through
scipy splu on the host (the reference's compute model) for a wall-time
and eigenvalue cross-check.

Writes SCALE.json at the repo root (bench.py surfaces a summary).

Usage:  python examples/scale_beyn.py [--nsplit 2] [--N 32] [--method slab]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsplit", type=int, default=2)
    ap.add_argument("--N", type=int, default=32, help="Gauss nodes/edge")
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--method", default="slab", choices=["slab", "gmres"])
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--restart", type=int, default=30)
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--res-tol", type=float, default=1e-6)
    ap.add_argument("--refine-tol", type=float, default=1e-8,
                    help="slab refinement target (relres, equilibrated)")
    ap.add_argument("--host-check", action="store_true",
                    help="host splu contour cross-check (slow)")
    ap.add_argument("--host-nodes", type=int, default=None,
                    help="host-check only this many quadrature nodes and "
                         "EXTRAPOLATE the wall time linearly (per-node "
                         "splu cost is node-independent); the host "
                         "eigenvalue cross-check is skipped in that mode")
    ap.add_argument("--contour", default=None,
                    help="fre_lo,fre_hi,fim (Hz): rectangle "
                         "[lo-i·fim, hi+i·fim] — default 150,1000,5")
    ap.add_argument("--mode-check", type=int, default=0, metavar="MAXITER",
                    help="per-mode host cross-check: polish every accepted "
                         "fine mode with a host mslp (MAXITER iterations, "
                         "one sparse LU each) and record |Δf| — the "
                         "affordable tier-2 substitute for a full host "
                         "contour (VERDICT r4 #3/#4)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint", default="/tmp/scale_moments.npz",
                    help="moment-checkpoint path (digest-validated; lets "
                         "an interrupted contour resume)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    # Fire ONE trivial async dispatch immediately: the shared-pool device
    # session pays a large, variable one-time init on its first program
    # execution (measured 15 s .. 560 s depending on pool load).  Starting
    # it now overlaps that init with all the host-side setup below; the
    # fetch before the contour solve measures what's left and SCALE.json
    # reports it separately — the contour wall time is the algorithm,
    # session_warmup_s is the infrastructure.
    t_w0 = time.time()
    warm = jax.jit(lambda x: x + 1.0)(jnp.float32(0.0))

    from wavesandeigenvalues_jl_tpu.mesh import octosplit, read_mesh
    from wavesandeigenvalues_jl_tpu.mesh.refine import p1_prolongation
    from wavesandeigenvalues_jl_tpu.models import discretize
    from wavesandeigenvalues_jl_tpu.nlevp.solvers import (beyn,
                                                          verify_eigenpairs)
    from wavesandeigenvalues_jl_tpu.ops.panel_solve import (CoarseGrid,
                                                            MultiGrid)
    from wavesandeigenvalues_jl_tpu.parallel.dist_beyn import beyn_batched

    g, R, Tu, Tb = 1.4, 287.05, 300.0, 1200.0
    ds = {"Interior": ("interior", ()),
          "Outlet": ("admittance", ("Y", 1e15))}

    def fld(m):
        return m.generate_field(
            lambda x, y, z: np.where(z < 0, np.sqrt(g * R * Tu),
                                     np.sqrt(g * R * Tb)), order="const")

    t0 = time.time()
    coarse = read_mesh("/root/reference/docs/src/Rijke_mm.msh", scale=1e-3)
    meshes, Ps = [coarse], []
    for _ in range(args.nsplit):
        Ps.append(p1_prolongation(meshes[-1]))
        meshes.append(octosplit(meshes[-1]))
    fine = meshes[-1]
    t_mesh = time.time() - t0

    t0 = time.time()
    if args.method == "gmres":
        fams = [discretize(m, ds, fld(m)) for m in meshes]
        Lc, Lf = fams[0], fams[-1]
    else:
        Lc = discretize(meshes[0], ds, fld(meshes[0]))
        Lf = discretize(fine, ds, fld(fine))
    t_assemble = time.time() - t0

    solver_kw = {}
    if args.method == "slab":
        solver_kw["refine_tol"] = args.refine_tol
    if args.method == "gmres":
        # full multilevel hierarchy: each V-cycle level bridges one 8×
        # octosplit refinement (a single 2-level jump stalls near 1e-3)
        if args.nsplit == 1:
            solver_kw["coarse"] = CoarseGrid(Lc, Ps[0])
        else:
            solver_kw["coarse"] = MultiGrid(fams[-2::-1], Ps[::-1], bs=64)
        solver_kw["restart"] = args.restart
        solver_kw["max_restarts"] = args.max_restarts
    if args.chunk:
        solver_kw["chunk"] = args.chunk

    if args.contour:
        lo, hi, im = (float(x) for x in args.contour.split(","))
    else:
        lo, hi, im = 150.0, 1000.0, 5.0
    Gamma = [2 * np.pi * (lo - 1j * im), 2 * np.pi * (hi - 1j * im),
             2 * np.pi * (hi + 1j * im), 2 * np.pi * (lo + 1j * im)]

    # coarse-mesh ground truth (host LU Beyn, BASELINE.md: ≈272/695 Hz)
    t0 = time.time()
    Om_c, _ = beyn(Lc, Gamma, l=args.l, N=64, rtol=1e-12, res_tol=args.res_tol)
    t_coarse = time.time() - t0
    f_coarse = np.sort(Om_c.real) / 2 / np.pi

    # host splu cross-check FIRST when requested (the reference's compute
    # model: one factorization per node).  It is pure host CPU, so the
    # device session's one-time init — fired asynchronously at the top of
    # main — overlaps it completely instead of stalling the device phase.
    host_rec = None
    host_extrap = None
    if args.host_check:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spl

        from wavesandeigenvalues_jl_tpu.nlevp.solvers import (
            gauss_nodes, initialize_V, moments2eigs, pos_test)
        zs, ws = gauss_nodes(Gamma, args.N)
        Vh = initialize_V(Lf.size, args.l)
        S = Lf._stack()
        vals128 = np.asarray(S.values, np.complex128)
        eig = Lf.eigval
        n_host = len(zs) if args.host_nodes is None else min(
            args.host_nodes, len(zs))
        t0 = time.time()
        Ah = np.zeros((Lf.size, args.l, 2), np.complex128)
        for z, w in zip(zs[:n_host], ws[:n_host]):
            Lf.params[eig] = complex(z)
            data = Lf.coefficients({}) @ vals128
            M = sp.csr_matrix((data, S.indices, S.indptr),
                              shape=S.shape).tocsc()
            X = spl.splu(M).solve(Vh)
            Ah[:, :, 0] += w * X
            Ah[:, :, 1] += w * z * X
        t_host = time.time() - t0
        if n_host < len(zs):
            host_extrap = (t_host, n_host,
                           t_host * len(zs) / n_host)
            print(f"host splu subset: {n_host}/{len(zs)} nodes in "
                  f"{t_host:.0f}s -> extrapolated {host_extrap[2]:.0f}s")
        else:
            Omh, Ph = moments2eigs([Ah], rtol_sigma=1e-12)
            Omh, Ph = pos_test(Omh, Ph, Gamma)
            Omh, Ph, resh = verify_eigenpairs(Lf, Omh, Ph,
                                              res_tol=args.res_tol)
            host_rec = (np.sort(Omh.real) / 2 / np.pi, t_host)

    # settle the device session before timing the contour (see top of
    # main): t_session = dispatch→ready (init overlapped with the host
    # work above), t_session_wait = the un-overlapped remainder we
    # actually blocked on here
    t_f0 = time.time()
    float(warm)
    t_session = time.time() - t_w0
    t_session_wait = time.time() - t_f0

    t0 = time.time()
    Om, _P, res, minfo = beyn_batched(
        Lf, Gamma, l=args.l, N=args.N, rtol=1e-12, dense=False,
        output=True, method=args.method, res_tol=args.res_tol,
        return_residuals=True, return_info=True,
        checkpoint=args.checkpoint, **solver_kw)
    t_fine = time.time() - t0
    phases = dict(minfo.get("solver_timings", {}))
    # prep_s runs on a worker thread OVERLAPPED with device work — the
    # serial wall decomposition is wait + device + residual; prep_s is
    # reported as context (how much work the overlap hid)
    serial_keys = ("prep_wait_s", "device_s", "residual_s")
    phases["host_tail_s"] = t_fine - sum(
        phases.get(k, 0.0) for k in serial_keys)
    order = np.argsort(Om.real)
    f_fine = Om.real[order] / 2 / np.pi
    Om_sorted = Om[order]
    res = res[order]

    # per-mode host cross-check: warm-started host mslp from each Beyn
    # estimate (1 sparse LU per iteration).  Far cheaper than a full
    # host contour at tier-2 size; reports the SAME device_vs_host_hz
    # agreement evidence tier 1 carries.
    mode_checks = None
    if args.mode_check and len(Om_sorted):
        from wavesandeigenvalues_jl_tpu.nlevp import mslp
        from wavesandeigenvalues_jl_tpu.nlevp.solvers import (
            row_equilibrated_residual)
        mode_checks = []
        for om, Pv_col in zip(Om_sorted, _P[:, order].T):
            t0 = time.time()
            try:
                sol_m, its_m, flag_m = mslp(
                    Lf, complex(om), maxiter=args.mode_check, tol=1e-9,
                    v0=np.ascontiguousarray(Pv_col))
                om_h = sol_m.params[sol_m.eigval]
                req = row_equilibrated_residual(Lf(complex(om_h)), sol_m.v)
                mode_checks.append({
                    "beyn_hz": float(om.real / 2 / np.pi),
                    "host_hz": float(om_h.real / 2 / np.pi),
                    "dev_vs_host_hz": float(abs(om - om_h) / 2 / np.pi),
                    "host_flag": int(flag_m), "host_iters": int(its_m),
                    "host_equilibrated_residual": float(req),
                    "wall_s": time.time() - t0,
                })
            except Exception as e:  # surface, don't hide
                mode_checks.append({
                    "beyn_hz": float(om.real / 2 / np.pi),
                    "error": f"{type(e).__name__}: {e}",
                    "wall_s": time.time() - t0,
                })
            print("mode check:", mode_checks[-1])

    drift = [float(min(abs(f_fine - fc))) if len(f_fine) else None
             for fc in f_coarse]
    rec = {
        "nsplit": args.nsplit,
        "max_solve_relres": minfo.get("max_relres"),
        "device_kind": jax.devices()[0].device_kind,
        "method": args.method,
        "fine_dim": int(Lf.size),
        "fine_nnz": int(Lf._stack().nnz),
        "fine_tets": int(len(fine.tetrahedra)),
        "coarse_dim": int(Lc.size),
        "contour_nodes": 4 * args.N,
        "probe_cols": args.l,
        "n_modes_fine": int(len(f_fine)),
        "n_modes_coarse": int(len(f_coarse)),
        "passive_hz_fine": [float(f) for f in f_fine],
        "eig_residuals": [float(r) for r in res],
        "res_tol": args.res_tol,
        "passive_hz_coarse": [float(f) for f in f_coarse],
        "drift_vs_coarse_hz": drift,
        "wall_s": {"mesh": t_mesh, "assemble": t_assemble,
                   "session_warmup": t_session,
                   "session_warmup_wait": t_session_wait,
                   "beyn_fine_device": t_fine,
                   "beyn_fine_device_incl_warmup": t_fine + t_session_wait,
                   "beyn_coarse_host": t_coarse,
                   "fine_solver_phases": phases},
        "solver": solver_kw if args.method == "gmres"
        else {"method": "slab", "chunk": args.chunk,
              "refine_tol": args.refine_tol},
    }
    if "coarse" in rec["solver"]:
        rec["solver"] = {k: v for k, v in rec["solver"].items()
                         if k != "coarse"}

    if mode_checks is not None:
        rec["mode_checks"] = mode_checks
        ok = [m["dev_vs_host_hz"] for m in mode_checks
              if "dev_vs_host_hz" in m]
        rec["device_vs_host_hz"] = ok or None

    if host_extrap is not None:
        rec["wall_s"]["host_lu_subset"] = host_extrap[0]
        rec["host_lu_subset_nodes"] = host_extrap[1]
        rec["wall_s"]["beyn_fine_host_lu_extrapolated"] = host_extrap[2]

    if host_rec is not None:
        fh, t_host = host_rec
        rec["wall_s"]["beyn_fine_host_lu"] = t_host
        rec["passive_hz_host_fine"] = [float(f) for f in fh]
        rec["n_modes_host_fine"] = int(len(fh))
        rec["device_vs_host_hz"] = (
            [float(min(abs(f_fine - f))) for f in fh] if len(f_fine)
            else None)

    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, "SCALE.json")
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
