"""1-D thermoacoustic network models in Riemann invariants.

Counterpart of the reference's Network module
(/root/reference/src/network.jl).  The axial acoustic field in each
element is carried by forward/backward waves F, G:

    p   = F·exp(+iωl/c) + G·exp(-iωl/c)
    A·u = A/(ρc)·[F·exp(+iωl/c) - G·exp(-iωl/c)]

Each element contributes a small dense stamp enforcing continuity of p and
A·u (plus its own jump physics) between its two unknowns (F, G) and the
neighbours'.  ``discretize_network`` stamps the element blocks into a dense
2N×2N operator family over ω — small dense NLEVPs that ride the generic
solver stack unchanged (the whole family is a few dense tiles).

Element library (network.jl:26-281): duct, terminal (unode R=+1 /
pnode R=-1 / anechoic R=0), n-τ flame jump, sidewall Helmholtz damper with
frequency-dependent impedance, generic sidewall impedance, and the
linear-Helmholtz-resonator (lhr) metamaterial model.  Unlike the
reference, damper admittances 1/Z(ω) carry analytic derivatives of any
order (algebra.Reciprocal) instead of NaN beyond first order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..nlevp.algebra import (ExpAz, Pow, Reciprocal, exp_delay, pow1)
from ..nlevp.family import OperatorFamily, Term
from ..ops.sparse import CSR
from ..utils.config import CDTYPE


def _rho(c: float) -> float:
    """Air density at atmospheric pressure for a given speed of sound
    (ρ = γ·p0/c², network.jl:26)."""
    return 1.4 * 101325.0 / c ** 2


def duct(l, c, A, rho=None) -> List[Tuple]:
    """Duct element stamps (duct, network.jl:26-57): wave propagation over
    length l plus p / A·u continuity with the previous element."""
    rho = _rho(c) if rho is None else rho
    Y = A / (rho * c)
    M = np.zeros((4, 2), CDTYPE)
    M[0] = [-1, -1]
    M[1] = [-Y, Y]
    ep, em = ExpAz(1j * l / c), ExpAz(-1j * l / c)
    M31 = np.zeros((4, 2), CDTYPE); M31[2, 0] = 1
    M32 = np.zeros((4, 2), CDTYPE); M32[2, 1] = 1
    M41 = np.zeros((4, 2), CDTYPE); M41[3, 0] = Y
    M42 = np.zeros((4, 2), CDTYPE); M42[3, 1] = -Y
    return [
        (M, (), (), ""),
        (M31, (ep,), (("ω",),), f"exp(+iω{l}/{c})"),
        (M32, (em,), (("ω",),), f"exp(-iω{l}/{c})"),
        (M41, (ep,), (("ω",),), f"exp(+iω{l}/{c})"),
        (M42, (em,), (("ω",),), f"exp(-iω{l}/{c})"),
    ]


def terminal(R, c, A, rho=None, init=True) -> List[Tuple]:
    """Terminal with reflection coefficient R (terminal,
    network.jl:73-91): R=+1 velocity node, R=-1 pressure node, R=0
    anechoic."""
    rho = _rho(c) if rho is None else rho
    Y = A / (rho * c)
    if init:
        M = np.array([[R, -1.0],
                      [1.0, 1.0],
                      [Y, -Y]], CDTYPE)
    else:
        M = np.array([[-1.0, -1.0],
                      [-Y, Y],
                      [-1.0, R]], CDTYPE)
    return [(M, (), (), "")]


def flame(c1, c2, A, rho=None) -> List[Tuple]:
    """Zero-length n-τ flame jump (flame, network.jl:105-114): duct(0)
    continuity plus the Rankine-Hugoniot heat-release jump in A·u with
    gain n·exp(-iωτ)."""
    rho = _rho(c1) if rho is None else rho
    out = duct(0.0, c1, A, rho)
    M = np.zeros((4, 2), CDTYPE)
    M[3] = [1.0, -1.0]
    M *= (c2 ** 2 / c1 ** 2 - 1.0) * A / (rho * c1)
    out.append((M, (pow1, exp_delay), (("n",), ("ω", "τ")),
                "n*exp(-iωτ)"))
    return out


def _helmholtz_impedance(V, l_n, d_n, c, A, rho):
    """Mechel's Helmholtz-damper impedance Z(ω) (network.jl:137-217):
    Z = ρ[ω²/(πc)(2-rₙ/rᵤ) + 0.425·M·c/Sₙ + i(ωl/Sₙ - c²/(ωV))]."""
    r_n = d_n / 2.0
    r_u = np.sqrt(A / np.pi)
    S_n = np.pi * r_n ** 2
    l_eff = l_n + 0.85 * r_n * (2 - r_n / r_u)
    mach = 0.0

    def Z(w, k):
        return rho * (Pow(2).eval((w,), (k,)) / (np.pi * c) * (2 - r_n / r_u)
                      + Pow(0).eval((w,), (k,)) * 0.425 * mach * c / S_n
                      + 1j * Pow(1).eval((w,), (k,)) * l_eff / S_n
                      - 1j * c ** 2 / V * Pow(-1).eval((w,), (k,)))
    return Z


def helmholtz(V, l_n, d_n, c, A, rho=None) -> List[Tuple]:
    """Sidewall Helmholtz damper (helmholtz, network.jl:137-217): a
    zero-length jump u_u = p_d/Z(ω) + u_d with Mechel's impedance."""
    rho = _rho(c) if rho is None else rho
    out = duct(0.0, c, A, rho)
    M21 = np.zeros((4, 2), CDTYPE)
    M21[1] = [-1.0, -1.0]
    adm = Reciprocal(_helmholtz_impedance(V, l_n, d_n, c, A, rho), "Z_h")
    out.append((-M21 / rho, (adm,), (("ω",),), "1/Z_h(ω)"))
    return out


def sidewallimp(imp, c, A, rho=None) -> List[Tuple]:
    """Generic frequency-dependent sidewall impedance jump
    (sidewallimp, network.jl:226-249); ``imp(ω,k)`` returns the k-th
    derivative of Z."""
    rho = _rho(c) if rho is None else rho
    out = duct(0.0, c, A, rho)
    M21 = np.zeros((4, 2), CDTYPE)
    M21[1] = [-1.0, -1.0]
    out.append((M21, (Reciprocal(imp, "Z"),), (("ω",),), "1/Z(ω)"))
    return out


def lhr(V, l_n, d_n, c, A, rho=None, output: bool = False) -> List[Tuple]:
    """Linear Helmholtz-resonator metamaterial element (lhr,
    network.jl:260-281; Lan et al. 2017): impedance with viscous √ω and
    radiation ω² losses."""
    rho = _rho(c) if rho is None else rho
    r_n = d_n / 2.0
    S_n = np.pi * r_n ** 2
    B0 = rho * c ** 2
    eta = 1.5e-5
    R_vis = rho * l_n / r_n * np.sqrt(eta / 2) * S_n
    R_rad = 0.25 * rho * r_n ** 2 / c * S_n
    l_eff = l_n + 1.7 * r_n
    Cm = V / (rho * c ** 2 * S_n ** 2)
    Mm = rho * l_eff * S_n
    w0 = 1.0 / np.sqrt(Cm * Mm)
    if output:
        print(f"M: {Mm}, C: {Cm}, freq: {w0}")
    Cc = B0 * S_n / (1j * w0 ** 2 * V) / S_n

    def Z(w, k):
        return (Cc * Pow(1).eval((w,), (k,))
                - Cc * w0 ** 2 * Pow(-1).eval((w,), (k,))
                - Cc * 1j * R_vis / Mm * Pow(0.5).eval((w,), (k,))
                - Cc * 1j * R_rad / Mm * Pow(2).eval((w,), (k,)))
    return sidewallimp(Z, c, A, rho)


_TERMINAL_R = {"unode": 1.0, "pnode": -1.0, "anechoic": 0.0}


def discretize_network(network: Sequence[Tuple]) -> OperatorFamily:
    """Stamp a network element list into a dense 2N×2N operator family
    (discretize, network.jl:323-387).

    ``network`` is a list of (kind, data) with kinds 'duct', 'flame',
    'helmholtz', 'lhr', 'sidewallimp', 'unode', 'pnode', 'anechoic'."""
    N = len(network)
    dim = 2 * N
    L = OperatorFamily(["ω", "λ"], [0.0, complex("inf")])
    i = j = 0
    for idx, (kind, data) in enumerate(network):
        if kind in _TERMINAL_R:
            if idx == 0:
                init = True
            elif idx == N - 1:
                init = False
            else:
                raise ValueError(
                    f"terminal element at intermediate position {idx}")
            terms = terminal(_TERMINAL_R[kind], *data, init=init)
        elif kind == "duct":
            terms = duct(*data)
        elif kind == "flame":
            terms = flame(*data)
            L.params.setdefault("n", 0.0)
            L.params.setdefault("τ", 0.0)
        elif kind == "helmholtz":
            terms = helmholtz(*data)
        elif kind == "lhr":
            terms = lhr(*data)
        elif kind == "sidewallimp":
            terms = sidewallimp(*data)
        else:
            raise ValueError(f"unknown network element {kind!r}")
        I, J = terms[0][0].shape
        for coeff, funcs, args, txt in terms:
            M = np.zeros((dim, dim), CDTYPE)
            M[i:i + I, j:j + J] = coeff
            L.push(Term(CSR.from_dense(M), tuple(funcs), tuple(args),
                        txt, "M"))
        i += I - 2
        j += 2
    return L


__all__ = ["discretize_network", "duct", "terminal", "flame", "helmholtz",
           "sidewallimp", "lhr"]
