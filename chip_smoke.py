"""Smoke run of the device eigensolve paths on one GPU (or four).

Runs, through the public entry points, the three device paths of the
Rijke-tube deployment (``__graft_entry__._flagship_family``: cold/hot
tube, Y=1e15 outlet, n–τ flame) and checks each against the host
complex128 path on the same operator:

  A  active, rijke_mesh() = 999 DOF: device ``mslp`` (the fused slab
     path) from 340 Hz, then ``perturb_fast`` to order 20 on the device
     LU and Padé[10/10] at τ = 1.5e-3;
  B  active, rijke_mesh(4, 58, 58) = 7,259 DOF: device ``mslp``;
  C  passive, octosplit(rijke_mesh(4, 58, 58)) = 57,210 DOF: ``beyn`` on
     [150, 1000] Hz with the slab backend; both passive modes (≈272 and
     ≈694 Hz) must come back under ``res_tol`` and agree with a host
     ``mslp`` polish started from each.

``--four`` runs only the distributed shift×row Beyn (``beyn_dist``,
2 shifts × 2 row shards, two-grid preconditioned GMRES) on four GPUs and
the single-GPU slab Beyn it is compared with.

Usage:  python chip_smoke.py [--four]

Prints the card's name and power limit, one line per phase, and as its
last line one JSON object ``{"ok": true, "device": {...}}``.  Exits
non-zero on any failure, and when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: contour of phases C and --four: the passive modes between 150 and 1000 Hz
GAMMA_HZ = np.array([150 + 5j, 150 - 5j, 1000 - 5j, 1000 + 5j])
#: passive Rijke modes the contour must find [Hz]
PASSIVE_HZ = (272.0, 694.0)
#: equilibrated-residual cutoff of the Beyn candidates
RES_TOL = 1e-6


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def on_platform(x, platform):
    """True when every buffer of array ``x`` lives on ``platform``."""
    return {d.platform for d in x.devices()} == {platform}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _mslp(L, backend, z0, tol=1e-11, maxiter=30):
    from wavesandeigenvalues_jl_tpu.nlevp import mslp
    from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend
    prev = set_solve_backend(backend)
    try:
        t0 = time.perf_counter()
        sol, its, flag = mslp(L, z0, maxiter=maxiter, tol=tol)
        return sol, its, flag, time.perf_counter() - t0
    finally:
        set_solve_backend(prev)


def phase_local(name, n_rings, nz, platform, perturb=False):
    """Device ``mslp`` against host ``mslp`` on the active flagship family
    (phases A and B); with ``perturb`` also the order-20 Taylor series in τ
    and its Padé[10/10] at τ = 1.5e-3."""
    from __graft_entry__ import _flagship_family
    from wavesandeigenvalues_jl_tpu.nlevp import perturb_fast
    from wavesandeigenvalues_jl_tpu.ops.linsolve import factorize
    from wavesandeigenvalues_jl_tpu.utils.config import set_solve_backend

    z0 = 2 * np.pi * 340
    L_d = _flagship_family(n_rings=n_rings, nz=nz)
    sol_d, its_d, flag_d, t_cold = _mslp(L_d, "device", z0)
    check(flag_d == 0, f"{name}: device mslp flag {flag_d}")
    solver = getattr(L_d, "_fused_solver", (None, None))[1]
    check(type(solver).__name__ == "FusedSlabPencilSolver",
          f"{name}: device mslp did not run the fused device solver")
    check(on_platform(solver.vals_r, platform)
          and on_platform(solver.rows2, platform),
          f"{name}: fused solver arrays are not on the {platform}")
    _, _, _, t_warm = _mslp(L_d, "device", z0)

    L_h = _flagship_family(n_rings=n_rings, nz=nz)
    sol_h, its_h, flag_h, t_h = _mslp(L_h, "host", z0)
    check(flag_h == 0, f"{name}: host mslp flag {flag_h}")
    om_h = sol_h.params["ω"]
    om_d = sol_d.params["ω"]
    d_om = abs(om_d - om_h)
    # both paths end in the same complex128 host Newton steps, stopped at
    # |dz| <= 1e-11 rad/s (1e-14 relative); 1e-10 relative leaves room
    # for one more or one fewer such step
    tol_om = 1e-10 * abs(om_h)
    rec = {"phase": name, "dof": L_d.size,
           "omega_rad_s": [om_d.real, om_d.imag],
           "wall_s_device_cold": t_cold, "wall_s_device_warm": t_warm,
           "wall_s_host": t_h, "iters_device": its_d, "iters_host": its_h,
           "abs_domega": d_om, "tol": tol_om}
    check(d_om <= tol_om, f"{name}: |Δω| {d_om:.3e} > {tol_om:.3e}")

    if perturb:
        tau = 1.5e-3
        perturb_fast(sol_h, L_h, "τ", 20)
        pade_h = sol_h("τ", tau, 10, 10)
        prev = set_solve_backend("device")
        try:
            t0 = time.perf_counter()
            perturb_fast(sol_d, L_d, "τ", 20)
            pade_d = sol_d("τ", tau, 10, 10)
            t_pert = time.perf_counter() - t0
            F = factorize(L_d(om_d))
        finally:
            set_solve_backend(prev)
        check(type(F).__name__ == "DeviceLU"
              and on_platform(F._fac[0], platform),
              f"{name}: perturbation factorization not on the {platform}")
        d_pade = abs(pade_d - pade_h)
        # 20 Taylor coefficients from one refined complex128 device LU vs
        # one host LU: coefficient k carries the solve error amplified by
        # the recursion, so the bound is looser than for ω itself
        tol_pade = 1e-8 * abs(pade_h)
        rec.update({"pade_10_10_rad_s": [pade_d.real, pade_d.imag],
                    "wall_s_perturb_device": t_pert,
                    "abs_dpade": d_pade, "tol_pade": tol_pade})
        check(d_pade <= tol_pade,
              f"{name}: Padé |Δω| {d_pade:.3e} > {tol_pade:.3e}")
    return rec


def _passive(mesh):
    from __graft_entry__ import flagship_dscrp, flagship_speed_of_sound
    from wavesandeigenvalues_jl_tpu.models import discretize
    return discretize(mesh, flagship_dscrp(active=False),
                      flagship_speed_of_sound(mesh))


def _check_modes(name, Om):
    hz = np.sort(np.real(np.asarray(Om)) / (2 * np.pi))
    check(len(hz) == len(PASSIVE_HZ)
          and all(abs(a - b) < 10.0 for a, b in zip(hz, PASSIVE_HZ)),
          f"{name}: contour modes {hz} Hz, expected near {PASSIVE_HZ}")
    return np.asarray(Om)[np.argsort(np.real(Om))]


def phase_contour(name, mesh, N):
    """Slab-backend ``beyn`` on the passive family against one host
    ``mslp`` polish started from each returned mode (phase C)."""
    from wavesandeigenvalues_jl_tpu.nlevp import beyn

    L = _passive(mesh)
    Gamma = 2 * np.pi * GAMMA_HZ
    t0 = time.perf_counter()
    Om, _P = beyn(L, Gamma, l=8, N=N, rtol=1e-12, res_tol=RES_TOL,
                  backend="slab")
    t_dev = time.perf_counter() - t0
    Om = _check_modes(name, Om)
    # Beyn's eigenvalues come from an N-node trapezoid quadrature and a
    # rank cut at rtol=1e-12; 1e-7 relative is 0.03 mHz at 272 Hz
    d_om, t_host, its = [], 0.0, []
    for om in Om:
        sol, it, flag, t = _mslp(L, "host", complex(om), tol=1e-9,
                                 maxiter=5)
        check(flag == 0, f"{name}: host polish from {om} flag {flag}")
        d_om.append(abs(sol.params["ω"] - om))
        t_host += t
        its.append(it)
    tol_om = [1e-7 * abs(om) for om in Om]
    rec = {"phase": name, "dof": L.size, "nodes_per_edge": N,
           "modes_hz": [[o.real / (2 * np.pi), o.imag / (2 * np.pi)]
                        for o in Om],
           "wall_s_device": t_dev, "wall_s_host_polish": t_host,
           "iters_host_polish": its, "abs_domega": d_om, "tol": tol_om}
    check(all(d <= t for d, t in zip(d_om, tol_om)),
          f"{name}: |Δω| {d_om} above {tol_om}")
    return rec


def phase_four(devices, n_rings, nz, N):
    """``beyn_dist`` on a (shift 2 × row 2) mesh of four devices against
    the single-device slab ``beyn`` on the same operator.  The fine mesh
    is the octosplit child of rijke_mesh(n_rings, nz, nz), which gives
    the two-grid preconditioner its coarse level."""
    from jax.sharding import Mesh

    from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
    from wavesandeigenvalues_jl_tpu.mesh.refine import (octosplit,
                                                        p1_prolongation)
    from wavesandeigenvalues_jl_tpu.nlevp import beyn
    from wavesandeigenvalues_jl_tpu.ops.panel_solve import CoarseGrid
    from wavesandeigenvalues_jl_tpu.parallel.dist_beyn import beyn_dist

    check(len(devices) == 4, f"--four needs 4 devices, got {len(devices)}")
    coarse = rijke_mesh(n_rings=n_rings, nz_cold=nz, nz_hot=nz)
    fine = octosplit(coarse)
    Lc, Lf = _passive(coarse), _passive(fine)
    Gamma = 2 * np.pi * GAMMA_HZ

    t0 = time.perf_counter()
    Om_1, _ = beyn(Lf, Gamma, l=8, N=N, rtol=1e-12, res_tol=RES_TOL,
                   backend="slab")
    t_one = time.perf_counter() - t0
    Om_1 = _check_modes("four/single", Om_1)

    mesh = Mesh(np.array(devices).reshape(2, 2), ("shift", "row"))
    t0 = time.perf_counter()
    Om_4, _ = beyn_dist(Lf, Gamma, mesh, n_row_parts=2, l=8, N=N,
                        rtol=1e-12, res_tol=RES_TOL, bs=16, tol=1e-11,
                        restart=40, max_restarts=20,
                        coarse=CoarseGrid(Lc, p1_prolongation(coarse)))
    t_four = time.perf_counter() - t0
    Om_4 = _check_modes("four/dist", Om_4)
    # devices 1-3 hold nothing until beyn_dist places its shards there
    stats = [d.memory_stats() for d in devices]
    peaks = [None if st is None else st.get("peak_bytes_in_use")
             for st in stats]
    if None not in peaks:
        check(all(p > 0 for p in peaks),
              f"four: peak bytes per device {peaks}: not all four used")
    d_om = [abs(a - b) for a, b in zip(Om_4, Om_1)]
    # both contours reduce the same quadrature; the distributed node
    # solves stop at GMRES relres 1e-11 where the slab solves are direct
    tol_om = [1e-7 * abs(o) for o in Om_1]
    rec = {"phase": "four", "dof": Lf.size, "nodes_per_edge": N,
           "mesh": "shift2 x row2",
           "modes_hz": [[o.real / (2 * np.pi), o.imag / (2 * np.pi)]
                        for o in Om_4],
           "wall_s_four": t_four, "wall_s_single": t_one,
           "peak_bytes_per_device": peaks,
           "abs_domega_vs_single": d_om, "tol": tol_om}
    check(all(d <= t for d, t in zip(d_om, tol_om)),
          f"four: |Δω| {d_om} above {tol_om}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed Beyn phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    import wavesandeigenvalues_jl_tpu  # noqa: F401  (x64, matmul precision)

    print("card:", card_line(), flush=True)
    if args.four:
        phases = [lambda: phase_four(devices[:4], n_rings=3, nz=12, N=32)]
    else:
        from wavesandeigenvalues_jl_tpu.mesh.generate import rijke_mesh
        from wavesandeigenvalues_jl_tpu.mesh.refine import octosplit
        phases = [
            lambda: phase_local("A", 3, 12, "gpu", perturb=True),
            lambda: phase_local("B", 4, 58, "gpu"),
            lambda: phase_contour("C", octosplit(rijke_mesh(
                n_rings=4, nz_cold=58, nz_hot=58)), N=64),
        ]
    for run in phases:
        print(json.dumps(run()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
