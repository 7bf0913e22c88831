"""Block-tridiagonal direct panel solver ("slab solver") on device.

The scalable DIRECT alternative to the GMRES panel path for the Beyn
contour quadrature (/root/reference/src/NLEVP/beyn.jl:62-74 runs |Γ|·N
independent UMFPACK factorizations; here all shifts in a chunk factorize
together as batched dense linear algebra).

Key observation: BFS level sets of ANY sparse operator's adjacency graph
have the property that every edge connects the same or adjacent levels —
so ordering DOFs by (merged) BFS level makes the operator block
tridiagonal with dense-padded slab blocks [s, s].  A block-Thomas
factorization is then m sequential steps of batched dense linear algebra

    Dt_i   = D_i − L_i · C_{i−1}
    C_i    = Dt_i⁻¹ U_i,     y_i = Dt_i⁻¹ (b_i − L_i y_{i−1})
    x_m    = y_m,            x_i = y_i − C_i x_{i+1}

batched over shifts.  For the 57k-DOF octosplit Rijke operator this is
m=119 slabs of width ≤579.

Design rules:

* EVERY pass is one ``lax.scan`` program (factorization, backward
  substitution, refinement sweeps) rather than a host-driven per-slab
  loop, which would pay one dispatch per slab and pass.
* All chunk-constant arrays (data planes, RHS planes, scatter/gather
  maps) are ``device_put`` ONCE, not re-transferred on every call.
* The per-slab block inverses ``Dt_i⁻¹`` are kept device-resident —
  refinement sweeps then need only matmuls, so iterative refinement
  against exact complex128 host residuals costs a few percent of the
  factorization.
* Rows are equilibrated per shift (1/max|row|) on host before shipping:
  penalty-BC rows (admittance Y~1e15) otherwise destroy a low-precision
  block factorization, and the refinement acceptance norm matches the
  scaled system.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import device_complex_dtype

#: device-memory budget (bytes) for the stored block inverses of a chunk
SLAB_BUDGET = float(os.environ.get("WAE_SLAB_BUDGET", "6.0e9"))


def _concat_ranges(starts, counts):
    """Concatenate ranges(starts[i], starts[i]+counts[i]) vectorized."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    out = np.ones(total, np.int64)
    ends = np.cumsum(counts)
    out[0] = starts[0]
    nz = counts > 0
    first = np.flatnonzero(nz)
    # at each range boundary, jump to the next start
    prev_end = starts[first[:-1]] + counts[first[:-1]]
    out[ends[first[:-1]]] = starts[first[1:]] - prev_end + 1
    return np.cumsum(out)


def bfs_levels(indptr, nbrs, n: int):
    """BFS level of every vertex from a pseudo-peripheral seed (two-pass);
    disconnected components continue the level numbering (no cross edges,
    so sharing slab indices across components stays block-tridiagonal)."""
    lvl = np.full(n, -1, np.int64)
    deg = np.diff(indptr)

    def _bfs(start, base, write):
        seen = lvl >= 0 if write else np.zeros(n, bool)
        local = np.full(n, -1, np.int64)
        frontier = np.array([start], np.int64)
        local[start] = 0
        seen[start] = True
        d = 0
        while frontier.size:
            counts = (indptr[frontier + 1] - indptr[frontier])
            nb = nbrs[_concat_ranges(indptr[frontier], counts)]
            nb = np.unique(nb[~seen[nb]])
            seen[nb] = True
            d += 1
            local[nb] = d
            frontier = nb
        if write:
            sel = local >= 0
            lvl[sel] = base + local[sel]
        return local

    base = 0
    todo = np.ones(n, bool)
    while todo.any():
        seed = int(np.flatnonzero(todo)[np.argmin(deg[todo])])
        l0 = _bfs(seed, 0, write=False)
        # farthest reached vertex of this component = better peripheral seed
        reach = l0 >= 0
        far = int(np.flatnonzero(reach)[np.argmax(l0[reach])])
        l1 = _bfs(far, base, write=True)
        comp = l1 >= 0
        base = int(lvl[lvl >= 0].max()) + 1
        todo &= ~comp
    return lvl


class SlabPartition:
    """DOF ordering by merged BFS levels: ``perm`` (new→old), slab sizes
    and, for every union-pattern nnz entry, its (slab, block, row, col)
    destination — everything the device assembly gathers/scatters need."""

    def __init__(self, indptr, indices, n: int, target: Optional[int] = None):
        from .reorder import adjacency_from_csr
        from .sparse import CSR
        A = CSR(np.asarray(indptr), np.asarray(indices),
                np.ones(len(indices)), (n, n))
        aptr, nbrs = adjacency_from_csr(A)
        lvl = bfs_levels(aptr, nbrs, n)
        sizes = np.bincount(lvl)

        # greedy merge of consecutive levels (edges only ever span one
        # level, so merged slabs stay tridiagonal)
        def merge(tgt):
            slab_of_level = np.empty(len(sizes), np.int64)
            cur, acc = 0, 0
            for k, sz in enumerate(sizes):
                if acc and acc + sz > tgt:
                    cur += 1
                    acc = 0
                slab_of_level[k] = cur
                acc += sz
            return slab_of_level

        if target is None:
            # auto-target: the stored block inverses cost m·smax² HBM
            # bytes per shift (re-read every refinement sweep — the
            # dominant resolve traffic) and the factorization m·smax³
            # flops; levels padded to the widest slab waste both, so
            # search merge targets for the one minimizing m·smax²
            # (tridiagonality holds for ANY consecutive-level merge)
            base = int(sizes.max())
            best_cost = None
            for mult in (1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0):
                tgt = int(base * mult)
                sol = merge(tgt)
                sl = sol[lvl]
                m_ = int(sl.max()) + 1
                smax_ = int(np.bincount(sl, minlength=m_).max())
                cost = m_ * smax_ * smax_
                if best_cost is None or cost < best_cost:
                    best_cost, target = cost, tgt
        slab_of_level = merge(target)
        slab = slab_of_level[lvl]
        self.m = int(slab.max()) + 1
        self.sizes = np.bincount(slab, minlength=self.m)
        self.smax = int(self.sizes.max())
        order = np.lexsort((np.arange(n), slab))
        self.perm = order                       # new -> old
        self.iperm = np.empty(n, np.int64)
        self.iperm[order] = np.arange(n)
        self.slab_of_new = slab[order]
        starts = np.zeros(self.m + 1, np.int64)
        np.cumsum(self.sizes, out=starts[1:])
        self.starts = starts
        self.loc_of_new = np.arange(n) - starts[self.slab_of_new]
        self.n = n

    def entry_destinations(self, rows, cols):
        """Per-nnz (slab i, block d∈{0:L,1:D,2:U}, row loc, col loc)."""
        rn = self.iperm[np.asarray(rows, np.int64)]
        cn = self.iperm[np.asarray(cols, np.int64)]
        si, sj = self.slab_of_new[rn], self.slab_of_new[cn]
        d = sj - si + 1
        if d.min() < 0 or d.max() > 2:
            raise AssertionError("BFS slab partition violated "
                                 "tridiagonality — this cannot happen")
        return si, d, self.loc_of_new[rn], self.loc_of_new[cn]


def _band_ell(si, rl, cl, sel, m: int, s: int, nnz: int):
    """Padded-ELL map of one off-diagonal band: for every (slab, row-loc)
    the nnz ids and column locs of its entries, padded to the widest row
    (sentinel id ``nnz`` gathers the appended zero value, col 0).  Lets
    the scan passes apply L·y / U·x as gather+reduce instead of
    re-scattering dense [s, s] blocks every step."""
    s_i = np.asarray(si)[sel]
    r_i = np.asarray(rl)[sel]
    c_i = np.asarray(cl)[sel]
    eids = np.flatnonzero(sel)
    key = s_i * s + r_i
    order = np.argsort(key, kind="stable")
    ks = key[order]
    if len(ks):
        first = np.r_[True, ks[1:] != ks[:-1]]
        start = np.maximum.accumulate(
            np.where(first, np.arange(len(ks)), 0))
        slot = np.arange(len(ks)) - start
        w = int(slot.max()) + 1
    else:
        slot = np.empty(0, np.int64)
        w = 1
    eid = np.full((m, s, w), nnz, np.int32)
    col = np.zeros((m, s, w), np.int32)
    eid[s_i[order], r_i[order], slot] = eids[order]
    col[s_i[order], r_i[order], slot] = c_i[order]
    return eid, col


# ---------------------------------------------------------------------------
# jitted device passes (one scan program each — see module docstring)

#: slab steps fused per scan iteration (the scan body is unrolled K
#: times: m/K loop iterations per pass)
SLAB_UNROLL = int(os.environ.get("WAE_SLAB_UNROLL", "4"))


def _scan_steps(step, init, xs, reverse: bool = False):
    """``lax.scan`` over the slab axis with SLAB_UNROLL steps fused per
    iteration.  ``step(carry, xs_i) -> (carry, ys_i)`` with ys_i a tuple;
    every xs leading dim must be divisible by SLAB_UNROLL (the solver
    pads the partition).  Returns (carry, ys) with ys stacked [m, ...]."""
    K = SLAB_UNROLL
    xsb = tuple(a.reshape((a.shape[0] // K, K) + a.shape[1:]) for a in xs)

    def body(carry, xsk):
        outs = [None] * K
        order = range(K - 1, -1, -1) if reverse else range(K)
        for k in order:
            carry, outs[k] = step(carry, tuple(a[k] for a in xsk))
        ys = tuple(jnp.stack([o[j] for o in outs])
                   for j in range(len(outs[0])))
        return carry, ys

    carry, ys = jax.lax.scan(body, init, xsb, reverse=reverse)
    return carry, tuple(y.reshape((-1,) + y.shape[2:]) for y in ys)


@jax.jit
def _factor_pass(dP, bP, eidx, dest, rmap, sizes, eidU, colU, src):
    """Full block-Thomas factorization + solve in ONE dispatch: forward
    elimination scan (with the batched dense solve in the body), then
    backward substitution and the un-permute gather.  In/out planes are
    PACKED [2, ...] (re, im) arrays: one transfer each way.  Returns stacked solution
    planes and the stored block inverses for refinement re-solves."""
    dr, di = dP[0], dP[1]
    br, bi = bP[0], bP[1]
    B = dr.shape[0]
    s = rmap.shape[1]
    l = br.shape[-1]
    b = jax.lax.complex(br, bi)
    arange_s = jnp.arange(s)

    def body(carry, xs):
        Cr, Ci, yr, yi = carry
        eidx_i, dest_i, rmap_i, size_i = xs
        blk = _scan_blk(dr, di, eidx_i, dest_i, s, B)
        Lb, Db, Ub = blk[:, 0], blk[:, 1], blk[:, 2]
        C = jax.lax.complex(Cr, Ci)
        y = jax.lax.complex(yr, yi)
        # pad empty tail rows of a short slab to identity
        pad = (arange_s >= size_i).astype(Db.dtype)
        Dt = Db - Lb @ C + jnp.diag(pad)[None]
        Eye = jnp.broadcast_to(jnp.eye(s, dtype=Dt.dtype), (B, s, s))
        Dtinv = jnp.linalg.solve(Dt, Eye)
        Cn = Dtinv @ Ub
        yn = jnp.matmul(Dtinv, b[:, rmap_i] - Lb @ y,
                        precision="highest")
        carry = (jnp.real(Cn), jnp.imag(Cn), jnp.real(yn), jnp.imag(yn))
        ys = (jnp.real(Dtinv), jnp.imag(Dtinv),
              jnp.real(yn), jnp.imag(yn))
        return carry, ys

    C0 = jnp.zeros((B, s, s), dr.dtype)
    y0 = jnp.zeros((B, s, l), dr.dtype)
    _, (DTr, DTi, Yr, Yi) = _scan_steps(
        body, (C0, C0, y0, y0), (eidx, dest, rmap, sizes))
    Xr, Xi = _bwd_slab_scan(DTr, DTi, Yr, Yi, dP, eidU, colU,
                            precision="highest")
    return jnp.stack(_unpermute(Xr, Xi, src)), DTr, DTi


def _scan_blk(dr, di, eidx_i, dest_i, s: int, B: int):
    """Assemble one slab's [B, 3, s, s] block panel from the chunk's
    data planes (gather + scatter-add, shapes static inside the scan)."""
    blkr = jnp.zeros((B, 3 * s * s + 1), dr.dtype).at[:, dest_i].add(
        dr[:, eidx_i])
    blki = jnp.zeros((B, 3 * s * s + 1), di.dtype).at[:, dest_i].add(
        di[:, eidx_i])
    return jax.lax.complex(blkr, blki)[:, :3 * s * s].reshape(B, 3, s, s)


def _band_apply(dr, di, eid_i, col_i, v):
    """(band_i @ v) via padded-ELL gather+reduce: ``eid_i/col_i`` [s, w]
    per-row nnz ids / neighbor-slab column locs, ``v`` [B, s, l] the
    neighboring slab's panel.  No dense [s, s] block is materialized —
    this is what keeps the scan passes off the serializing scatter."""
    vals = jax.lax.complex(dr[:, eid_i], di[:, eid_i])    # [B, s, w]
    vg = v[:, col_i, :]                                   # [B, s, w, l]
    return jnp.einsum("bsw,bswl->bsl", vals, vg)


def _slab_rhs(bP, rmap):
    """Pack the RHS into slab layout [m, B, s, l] planes (row n = 0)."""
    br, bi = bP[0], bP[1]
    return (br[:, rmap, :].transpose(1, 0, 2, 3),
            bi[:, rmap, :].transpose(1, 0, 2, 3))


def _fwd_slab_scan(DTr, DTi, dP, bsr, bsi, eidL, colL,
                   precision="highest"):
    """Forward re-solve y_i = Dt_i⁻¹ (b_i − L_i y_{i−1}) with the slab-
    layout RHS; returns slab-layout Y planes.

    ``precision``: matmul precision of the Dt⁻¹ application.  Keep
    "highest": single-pass "default" bf16 is amplified to O(1) error by
    the m-step recursion and stalls the refinement outright, and 3-pass
    "high" measured no faster on hardware while costing a digit of
    per-sweep gain."""
    dr, di = dP[0], dP[1]
    B, s, l = bsr.shape[1], bsr.shape[2], bsr.shape[3]

    def body(carry, xs):
        yr, yi = carry
        DTr_i, DTi_i, eidL_i, colL_i, br_i, bi_i = xs
        Dtinv = jax.lax.complex(DTr_i, DTi_i)
        y = jax.lax.complex(yr, yi)
        rhs = (jax.lax.complex(br_i, bi_i)
               - _band_apply(dr, di, eidL_i, colL_i, y))
        yn = jnp.matmul(Dtinv, rhs, precision=precision)
        out = (jnp.real(yn), jnp.imag(yn))
        return out, out

    y0 = (jnp.zeros((B, s, l), DTr.dtype), jnp.zeros((B, s, l), DTr.dtype))
    _, (Yr, Yi) = _scan_steps(body, y0, (DTr, DTi, eidL, colL, bsr, bsi))
    return Yr, Yi


def _bwd_slab_scan(DTr, DTi, Yr, Yi, dP, eidU, colU,
                   precision="highest"):
    """Backward substitution, returning SLAB-layout X planes (see
    _fwd_slab_scan for the ``precision`` rationale)."""
    dr, di = dP[0], dP[1]
    B, s, l = Yr.shape[1], Yr.shape[2], Yr.shape[3]

    def body(carry, xs):
        xr, xi = carry
        DTr_i, DTi_i, Yr_i, Yi_i, eidU_i, colU_i = xs
        Dtinv = jax.lax.complex(DTr_i, DTi_i)
        y_i = jax.lax.complex(Yr_i, Yi_i)
        x = jax.lax.complex(xr, xi)
        xn = y_i - jnp.matmul(
            Dtinv, _band_apply(dr, di, eidU_i, colU_i, x),
            precision=precision)
        out = (jnp.real(xn), jnp.imag(xn))
        return out, out

    x0 = (jnp.zeros((B, s, l), DTr.dtype), jnp.zeros((B, s, l), DTr.dtype))
    _, (Xr, Xi) = _scan_steps(body, x0, (DTr, DTi, Yr, Yi, eidU, colU),
                              reverse=True)
    return Xr, Xi


def _unpermute(Xr, Xi, src):
    m, B, s, l = Xr.shape
    flat_r = Xr.transpose(1, 0, 2, 3).reshape(B, m * s, l)
    flat_i = Xi.transpose(1, 0, 2, 3).reshape(B, m * s, l)
    return flat_r[:, src, :], flat_i[:, src, :]


@jax.jit
def _resolve_pass(DTr, DTi, dP, bP, eidL, colL, eidU, colU,
                  rmap, src):
    """One full refinement re-solve with the STORED block inverses —
    forward scan y_i = Dt_i⁻¹ (b_i − L_i y_{i−1}), reverse scan backward
    substitution, un-permute gather: ONE device dispatch per sweep
    (a host loop would cost ~2·m dispatches).
    Packed [2, ...] planes in and out (one transfer each way)."""
    bsr, bsi = _slab_rhs(bP, rmap)
    Yr, Yi = _fwd_slab_scan(DTr, DTi, dP, bsr, bsi, eidL, colL)
    Xr, Xi = _bwd_slab_scan(DTr, DTi, Yr, Yi, dP, eidU, colU)
    return jnp.stack(_unpermute(Xr, Xi, src))


def _shift_slabs(Xr, Xi, step):
    """Slab-layout panels of the ``step``-neighbouring slab (zero pad)."""
    z = jnp.zeros_like(Xr[:1])
    if step == -1:
        return (jnp.concatenate([z, Xr[:-1]]),
                jnp.concatenate([z, Xi[:-1]]))
    return (jnp.concatenate([Xr[1:], z]), jnp.concatenate([Xi[1:], z]))


@jax.jit
def _double_resolve_pass(DTr, DTi, dP, bP, eidL, colL, eidD, colD,
                         eidU, colU, rmap, src):
    """TWO refinement sweeps in ONE dispatch: re-solve, recompute the
    residual ON DEVICE (f32, slab-layout band matvecs — accurate enough
    while the relres is far above the f32 floor ~1e-7), re-solve the new
    residual, return the combined correction.  Halves the per-chunk
    host round trips of the refinement loop; the exact complex128
    residual check still happens on host between dispatches.  All device
    temporaries stay at slab granularity ([B, s, w, l]): a global-row
    residual gather would sit in device memory next to the stored
    inverses."""
    dr, di = dP[0], dP[1]
    bsr, bsi = _slab_rhs(bP, rmap)
    Yr, Yi = _fwd_slab_scan(DTr, DTi, dP, bsr, bsi, eidL, colL)
    X1r, X1i = _bwd_slab_scan(DTr, DTi, Yr, Yi, dP, eidU, colU)
    # slab-layout residual r_i = b_i − L_i x_{i−1} − D_i x_i − U_i x_{i+1}
    Xpr, Xpi = _shift_slabs(X1r, X1i, -1)
    Xnr, Xni = _shift_slabs(X1r, X1i, +1)

    def res_body(_, xs):
        (eidL_i, colL_i, eidD_i, colD_i, eidU_i, colU_i,
         br_i, bi_i, xpr, xpi, xcr, xci, xnr, xni) = xs
        r = (jax.lax.complex(br_i, bi_i)
             - _band_apply(dr, di, eidL_i, colL_i,
                           jax.lax.complex(xpr, xpi))
             - _band_apply(dr, di, eidD_i, colD_i,
                           jax.lax.complex(xcr, xci))
             - _band_apply(dr, di, eidU_i, colU_i,
                           jax.lax.complex(xnr, xni)))
        return None, (jnp.real(r), jnp.imag(r))

    _, (Rr, Ri) = _scan_steps(
        res_body, None, (eidL, colL, eidD, colD, eidU, colU,
                         bsr, bsi, Xpr, Xpi, X1r, X1i, Xnr, Xni))
    Y2r, Y2i = _fwd_slab_scan(DTr, DTi, dP, Rr, Ri, eidL, colL)
    X2r, X2i = _bwd_slab_scan(DTr, DTi, Y2r, Y2i, dP, eidU, colU)
    return jnp.stack(_unpermute(X1r + X2r, X1i + X2i, src))


class SlabSolver:
    """Matrix-free-assembled block-tridiagonal DIRECT solver for
    L(z_j) X_j = V panels at many shifts (same contract as
    :class:`.panel_solve.ShiftedPanelSolver`).

    Each chunk of shifts runs one batched block-Thomas factorization
    (a single scan dispatch of m steps of [B,s,s] dense device ops) and
    stores the block inverses, after which every refinement re-solve is
    one matmul/ELL-gather scan dispatch.  Mixed precision: f32
    factorization + exact complex128 host residuals + iterative
    refinement, judged in the row-equilibrated norm (the factorization
    itself runs on the equilibrated system)."""

    def __init__(self, family, chunk: Optional[int] = None,
                 target: Optional[int] = None,
                 refine_sweeps: int = 4, refine_tol: float = 1e-11):
        import scipy.sparse as sp
        self.family = family
        S = family._stack()
        self.n = int(S.shape[0])
        self.K = int(S.values.shape[0])
        self.nnz = int(S.nnz)
        self.refine_sweeps, self.refine_tol = refine_sweeps, refine_tol
        cdt = device_complex_dtype()
        self._rdt = np.float32 if cdt == np.complex64 else np.float64
        self._sp = sp
        self._indptr = np.asarray(S.indptr)
        self._indices = np.asarray(S.indices)
        self._values128 = np.asarray(S.values, np.complex128)
        rows = np.asarray(S.row_ids(), np.int64)
        self._rows = rows
        part = SlabPartition(S.indptr, S.indices, self.n, target=target)
        self.part = part
        m, s = part.m, part.smax
        si, d, rl, cl = part.entry_destinations(rows, self._indices)
        # per-slab scatter maps, padded to the widest slab: (eidx into the
        # data vector [nnz]+sentinel, dest into the [3*s*s] block panel
        # +dump slot).  Sentinel data is 0 so dump-slot collisions add 0.
        counts = np.bincount(si, minlength=m)
        self.emax = int(counts.max())
        eidx = np.full((m, self.emax), self.nnz, np.int32)
        dest = np.full((m, self.emax), 3 * s * s, np.int32)
        order = np.argsort(si, kind="stable")
        flat_dest = ((d * s + rl) * s + cl).astype(np.int32)
        pos = np.zeros(m, np.int64)
        off = np.concatenate([[0], np.cumsum(counts)])
        for i in range(m):
            sl = order[off[i]:off[i + 1]]
            eidx[i, :len(sl)] = sl
            dest[i, :len(sl)] = flat_dest[sl]
        self._eidx, self._dest = eidx, dest
        # per-slab RHS row map (new-order rows; sentinel row n is zero)
        rmap = np.full((m, s), self.n, np.int32)
        for i in range(m):
            rows_i = part.perm[part.starts[i]:part.starts[i + 1]]
            rmap[i, :len(rows_i)] = rows_i
        self._rmap = rmap
        # original DOF -> flat padded slab slot (device un-permute gather)
        newidx = part.iperm
        self._src = (part.slab_of_new[newidx] * s
                     + part.loc_of_new[newidx]).astype(np.int32)
        # padded-ELL maps of the L (d=0) and U (d=2) bands for the scan
        # passes (band matvecs without dense block re-assembly)
        self._eidL, self._colL = _band_ell(si, rl, cl, d == 0, m, s,
                                           self.nnz)
        self._eidU, self._colU = _band_ell(si, rl, cl, d == 2, m, s,
                                           self.nnz)
        # diagonal-band ELL for the on-device residual of the fused
        # double-refinement sweep (slab-granular temps; a global-row
        # residual gather OOMed next to the stored inverses)
        self._eidD, self._colD = _band_ell(si, rl, cl, d == 1, m, s,
                                           self.nnz)
        # pad the slab axis to a multiple of SLAB_UNROLL with empty slabs
        # (size 0 -> the factor body pads them to identity; all maps get
        # zero-value sentinels), so every scan pass can fuse K steps
        self.m_pad = -(-m // SLAB_UNROLL) * SLAB_UNROLL
        padm = self.m_pad - m
        if padm:
            def _pad(a, fill):
                ext = np.full((padm,) + a.shape[1:], fill, a.dtype)
                return np.concatenate([a, ext])
            self._eidx = _pad(self._eidx, self.nnz)
            self._dest = _pad(self._dest, 3 * s * s)
            self._rmap = _pad(self._rmap, self.n)
            for name in ("_eidL", "_eidU", "_eidD"):
                setattr(self, name, _pad(getattr(self, name), self.nnz))
            for name in ("_colL", "_colU", "_colD"):
                setattr(self, name, _pad(getattr(self, name), 0))
        self._sizes_pad = np.zeros(self.m_pad, np.int32)
        self._sizes_pad[:m] = part.sizes
        self._dev_maps_cache = None
        self._chunk = chunk
        self.timings = {"prep_s": 0.0, "device_s": 0.0, "residual_s": 0.0,
                        "factor_steps": 0, "resolve_steps": 0}

    # -- host helpers ------------------------------------------------------

    def coefficients(self, zs) -> np.ndarray:
        L = self.family
        eig = L.eigval
        saved = L.params[eig]
        out = np.zeros((len(zs), self.K), np.complex128)
        for i, z in enumerate(np.asarray(zs)):
            L.params[eig] = complex(z)
            out[i] = L.coefficients({})
        L.params[eig] = saved
        return out

    def _host_csr(self, coeff):
        data = coeff @ self._values128
        return self._sp.csr_matrix((data, self._indices, self._indptr),
                                   shape=(self.n, self.n))

    def _resid_matvec(self, mat, Xj):
        """Host residual SpMM — native multithreaded kernel when built
        (the in-refine-loop residuals run on the 2-core host inside the
        device wall; scipy's single-threaded matvec was a visible slice
        of device_s at chunk=16×l=8)."""
        from .. import native
        if native.available():
            Y = native.csr_spmm(mat.indptr, mat.indices, mat.data, Xj)
            if Y is not None:
                return Y
        return mat @ Xj

    def _auto_chunk(self) -> int:
        per_shift = (2 * self.part.m * self.part.smax ** 2    # Dtinv planes
                     + 2 * self.part.m * self.part.smax * 8   # y planes
                     ) * (4 if self._rdt == np.float32 else 8)
        return int(max(1, min(16, SLAB_BUDGET // per_shift)))

    def default_group(self, l: int) -> int:
        """Natural shift-group size for contour drivers (one chunk)."""
        return self._chunk or self._auto_chunk()

    def _planes(self, x):
        x = np.asarray(x)
        return (np.ascontiguousarray(x.real).astype(self._rdt),
                np.ascontiguousarray(x.imag).astype(self._rdt))

    def _packed(self, x):
        """One [2, ...] (re, im) array on device — a single host→device
        transfer instead of two."""
        x = np.asarray(x)
        P = np.empty((2,) + x.shape, self._rdt)
        P[0], P[1] = x.real, x.imag
        return jax.device_put(P)

    def _equilibrate(self, coeffs):
        """Per-shift row scalings 1/max|row| of L(z) ([B, n]) and the
        scaled data planes ([B, nnz+1], sentinel 0 appended)."""
        B = coeffs.shape[0]
        data = coeffs @ self._values128                    # [B, nnz]
        absd = np.abs(data)
        srow = np.empty((B, self.n))
        seg = np.maximum.reduceat(absd, self._indptr[:-1], axis=1)
        empty = np.diff(self._indptr) == 0
        seg[:, empty] = 1.0
        srow[:] = 1.0 / np.where(seg == 0, 1.0, seg)
        data *= srow[:, self._rows]
        dpad = np.concatenate([data, np.zeros((B, 1), data.dtype)], axis=1)
        return srow, dpad

    # -- device sweeps -----------------------------------------------------

    def _factor_solve_chunk(self, dpad, bsc):
        """Factorize + solve one chunk: ``dpad`` [B, nnz+1] equilibrated
        data, ``bsc`` [B, n+1, l] equilibrated RHS (row n zero).  Returns
        (X [B, n, l] host c128, device buffers (DTr, DTi) for re-solves).

        One device dispatch: the chunk's planes ship once (per-step numpy
        arguments would re-transfer them on every call) and the whole
        factorization runs as a fused scan program."""
        dP = self._packed(dpad)
        bP = self._packed(bsc)
        d = self._dev_maps()
        X2, DTr, DTi = _factor_pass(
            dP, bP, d["eidx"], d["dest"], d["rmap"], d["sizes"],
            d["eidU"], d["colU"], d["src"])
        self.timings["factor_steps"] += self.part.m
        X2h = np.asarray(X2, np.float64)
        X = X2h[0] + 1j * X2h[1]                          # [B, n, l]
        return X, (DTr, DTi, dP)

    def _dev_maps(self):
        """Device-resident scatter/gather maps (shipped once per solver)."""
        if self._dev_maps_cache is None:
            host = {"eidx": self._eidx, "dest": self._dest,
                    "rmap": self._rmap, "src": self._src,
                    "sizes": self._sizes_pad,
                    "eidL": self._eidL, "colL": self._colL,
                    "eidU": self._eidU, "colU": self._colU,
                    "eidD": self._eidD, "colD": self._colD}
            self._dev_maps_cache = {k: jax.device_put(v)
                                    for k, v in host.items()}
        return self._dev_maps_cache

    def _resolve_chunk(self, fact, bsc, l):
        """Re-solve with stored inverses — one scan dispatch per sweep."""
        DTr, DTi, dP = fact
        bP = self._packed(bsc)
        d = self._dev_maps()
        X2 = _resolve_pass(DTr, DTi, dP, bP,
                           d["eidL"], d["colL"], d["eidU"], d["colU"],
                           d["rmap"], d["src"])
        self.timings["resolve_steps"] += self.part.m
        X2h = np.asarray(X2, np.float64)
        return X2h[0] + 1j * X2h[1]

    def _double_resolve_chunk(self, fact, bsc, l):
        """Two refinement sweeps per dispatch (device f32 mid-residual)."""
        DTr, DTi, dP = fact
        bP = self._packed(bsc)
        d = self._dev_maps()
        X2 = _double_resolve_pass(DTr, DTi, dP, bP,
                                  d["eidL"], d["colL"], d["eidD"],
                                  d["colD"], d["eidU"], d["colU"],
                                  d["rmap"], d["src"])
        self.timings["resolve_steps"] += 2 * self.part.m
        X2h = np.asarray(X2, np.float64)
        return X2h[0] + 1j * X2h[1]

    # -- public API --------------------------------------------------------

    def _prep_chunk(self, c, b):
        """Host-side chunk preparation: residual CSR matrices, row
        equilibration, scaled RHS.  Runs on a worker thread so chunk k+1's
        prep overlaps chunk k's device factorization (scipy/numpy release
        the GIL for the heavy parts)."""
        t0 = time.perf_counter()
        chunk = len(c)
        l = b.shape[2]
        mats = [self._host_csr(c[j]) for j in range(chunk)]
        srow, dpad = self._equilibrate(c)
        bsc = np.zeros((chunk, self.n + 1, l), np.complex128)
        bsc[:, :self.n] = b * srow[:, :, None]
        bnorm = np.linalg.norm(bsc, axis=1)              # [B, l] scaled
        bnorm = np.where(bnorm == 0, 1.0, bnorm)
        return {"mats": mats, "srow": srow, "dpad": dpad, "bsc": bsc,
                "bnorm": bnorm, "b": b,
                "prep_s": time.perf_counter() - t0}

    def solve(self, zs, V, output: bool = False, X0=None):
        """X[j] = L(z_j)⁻¹ V to complex128 accuracy (same contract as
        ShiftedPanelSolver.solve; ``X0`` accepted for interface parity and
        ignored — a direct solve needs no warm start)."""
        from concurrent.futures import ThreadPoolExecutor
        zs = np.asarray(zs)
        Sn = len(zs)
        V = np.asarray(V, np.complex128)
        if V.ndim == 2:
            Bfull = np.broadcast_to(V[None], (Sn,) + V.shape).copy()
        else:
            Bfull = np.ascontiguousarray(V)              # [S, n, l]
        l = Bfull.shape[2]
        coeffs = self.coefficients(zs)
        cmax = self._chunk or self._auto_chunk()
        X = np.empty((Sn, self.n, l), np.complex128)
        relres = np.empty((Sn, l))
        # chunk boundaries up front so the worker can prep chunk k+1
        # while the device factorizes chunk k
        bounds = []
        s0 = 0
        while s0 < Sn:
            rem = Sn - s0
            chunk = min(cmax, 1 << (rem - 1).bit_length())
            s1 = min(s0 + chunk, Sn)
            bounds.append((s0, s1, chunk))
            s0 = s1

        def chunk_inputs(s0, s1, chunk):
            pad = chunk - (s1 - s0)
            c = coeffs[s0:s1]
            b = Bfull[s0:s1]
            if pad:
                c = np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                b = np.concatenate([b, np.repeat(b[-1:], pad, 0)])
            return c, b

        pool = ThreadPoolExecutor(max_workers=1)
        try:
            fut = pool.submit(self._prep_chunk, *chunk_inputs(*bounds[0]))
            self._solve_chunks(bounds, chunk_inputs, fut, pool, X, relres,
                               l, output)
        finally:
            pool.shutdown(wait=True)
        info = {"relres": relres, "max_relres": float(relres.max()),
                "timings": dict(self.timings)}
        return X, info

    def _solve_chunks(self, bounds, chunk_inputs, fut, pool, X, relres, l,
                      output):
        for ci, (s0, s1, chunk) in enumerate(bounds):
            t_w0 = time.perf_counter()
            P = fut.result()
            t_wait = time.perf_counter() - t_w0
            if ci + 1 < len(bounds):
                fut = pool.submit(self._prep_chunk,
                                  *chunk_inputs(*bounds[ci + 1]))
            mats, srow, dpad = P["mats"], P["srow"], P["dpad"]
            bsc, bnorm, b = P["bsc"], P["bnorm"], P["b"]
            t1 = time.perf_counter()
            Xc, fact = self._factor_solve_chunk(dpad, bsc)
            t2 = time.perf_counter()
            # exact c128 residuals in the equilibrated norm + refinement
            best = Xc
            R = np.empty_like(bsc)
            best_res = np.empty((chunk, l))
            for j in range(chunk):
                R[j, :self.n] = ((b[j] - self._resid_matvec(mats[j], best[j]))
                                 * srow[j][:, None])
                R[j, self.n] = 0.0
                best_res[j] = np.linalg.norm(R[j], axis=0) / bnorm[j]
            t3 = time.perf_counter()
            prev_max = np.inf
            # each iteration = 2 fused sweeps in one dispatch (f32
            # device residual between them — see _double_resolve_pass)
            for sweep in range(-(-self.refine_sweeps // 2)):
                cur_max = float(best_res.max())
                if output:
                    print(f"slab refine sweep {sweep}: max relres "
                          f"{cur_max:.3e}")
                if cur_max < self.refine_tol or cur_max > 0.25 * prev_max:
                    break
                prev_max = cur_max
                # adaptive sweep depth: each sweep gains ~κ·ε_f32 ≈ 1e-3,
                # so when one sweep suffices to land refine_tol the
                # double-dispatch would waste its second sweep
                if cur_max < self.refine_tol * 1e3:
                    dX = self._resolve_chunk(fact, R, l)
                else:
                    dX = self._double_resolve_chunk(fact, R, l)
                t_h0 = time.perf_counter()
                cand = best + dX
                for j in range(chunk):
                    Rc = np.zeros_like(R[j])
                    Rc[:self.n] = ((b[j]
                                    - self._resid_matvec(mats[j], cand[j]))
                                   * srow[j][:, None])
                    rc = np.linalg.norm(Rc, axis=0) / bnorm[j]
                    upd = rc < best_res[j]
                    best[j][:, upd] = cand[j][:, upd]
                    best_res[j][upd] = rc[upd]
                    R[j][:, upd] = Rc[:, upd]
                self.timings["refine_host_resid_s"] = (
                    self.timings.get("refine_host_resid_s", 0.0)
                    + time.perf_counter() - t_h0)
            t4 = time.perf_counter()
            # prep_s = worker-thread wall; prep_wait_s = the un-hidden
            # remainder the main loop actually blocked on (chunk k+1's
            # prep overlaps chunk k's device work)
            self.timings["prep_s"] += P["prep_s"]
            self.timings["prep_wait_s"] = (
                self.timings.get("prep_wait_s", 0.0) + t_wait)
            self.timings["device_s"] += (t2 - t1) + (t4 - t3)
            self.timings["device_factor_s"] = (
                self.timings.get("device_factor_s", 0.0) + (t2 - t1))
            self.timings["device_refine_s"] = (
                self.timings.get("device_refine_s", 0.0) + (t4 - t3))
            self.timings["residual_s"] += t3 - t2
            if output:
                print(f"slab chunk [{s0}:{s1}]: prep {P['prep_s']:.1f}s "
                      f"(waited {t_wait:.1f}s)  factor+bwd {t2 - t1:.1f}s  "
                      f"residual {t3 - t2:.1f}s  refine {t4 - t3:.1f}s")
            X[s0:s1] = best[:s1 - s0]
            relres[s0:s1] = best_res[:s1 - s0]
            del fact


__all__ = ["SlabSolver", "SlabPartition", "bfs_levels", "SLAB_BUDGET"]
