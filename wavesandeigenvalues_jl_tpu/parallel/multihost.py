"""Multi-process initialization and mesh construction.

The reference is a single-core code (SURVEY §2.9).  This module makes a
multi-process run a CONFIG change rather than new code:

* :func:`init_multihost` — guarded ``jax.distributed.initialize``; a
  strict no-op when nothing is configured, env-driven otherwise (each
  process sets coordinator address / process count / process id).
* :func:`pod_mesh` — one (host × shift × row) device mesh over all
  globally-visible devices.  The axes follow the algorithm: ``row``
  carries the intra-solve halo ppermutes and psums, ``shift`` the
  embarrassingly-parallel quadrature nodes, and ``host`` (one entry per
  process) the final moment psum.
* :func:`pod_spec_check` — validates a (host × shift × row) spec on the
  virtual CPU mesh (used by ``__graft_entry__.dryrun_multichip``), so the
  sharding program is compile-checked in CI.

Env contract (each process):
  WAE_COORDINATOR=host0:port   WAE_NUM_PROCESSES=N   WAE_PROCESS_ID=k
or WAE_MULTIHOST=1 for a cluster environment JAX detects by itself.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_initialized = False


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Initialize JAX's multi-process runtime when configured; no-op
    otherwise.  Returns True when running multi-host.

    Explicit arguments win over the ``WAE_*`` env vars; with neither
    present (this single-host environment) nothing is touched."""
    global _initialized
    import jax
    if _initialized:
        return jax.process_count() > 1
    coordinator = coordinator or os.environ.get("WAE_COORDINATOR")
    auto = os.environ.get("WAE_MULTIHOST", "0") == "1"
    if coordinator is None and not auto:
        return False
    kw = {}
    if coordinator is not None:
        kw["coordinator_address"] = coordinator
        kw["num_processes"] = int(
            num_processes if num_processes is not None
            else os.environ["WAE_NUM_PROCESSES"])
        kw["process_id"] = int(
            process_id if process_id is not None
            else os.environ["WAE_PROCESS_ID"])
    jax.distributed.initialize(**kw)
    _initialized = True
    return jax.process_count() > 1


def pod_mesh(n_shift: Optional[int] = None, n_row: Optional[int] = None,
             devices=None):
    """(host × shift × row) Mesh over all globally-visible devices.

    ``n_shift``/``n_row`` split the PER-HOST devices (their product must
    equal the per-host device count; default: all per-host devices on the
    row axis).  The leading ``host`` axis has one entry per process, so
    collectives over "shift"/"row" stay inside a process while only the
    "host"-axis reductions (moment sums) cross processes — matching the
    Beyn quadrature's communication structure (one psum of the [d,l,2K]
    moments at the very end, dist_beyn.py)."""
    import jax
    from jax.sharding import Mesh
    if devices is not None:
        devs = np.asarray(devices)
        # explicit device grids carry the host grouping on axis 0
        # (virtual-mesh checks); flat lists mean one host
        n_host = devs.shape[0] if devs.ndim == 2 else 1
        devs = devs.reshape(-1)
    else:
        devs = np.asarray(jax.devices())
        n_host = jax.process_count()
    per_host = len(devs) // n_host
    if n_row is None and n_shift is None:
        n_shift, n_row = 1, per_host
    elif n_row is None:
        n_row = per_host // n_shift
    elif n_shift is None:
        n_shift = per_host // n_row
    if n_shift * n_row != per_host:
        raise ValueError(f"shift×row = {n_shift}×{n_row} != per-host "
                         f"device count {per_host}")
    if devices is not None:
        # honor the caller's explicit device list (virtual-mesh checks)
        grid = devs.reshape(n_host, n_shift, n_row)
    else:
        order = sorted(range(len(devs)),
                       key=lambda i: (devs[i].process_index, devs[i].id))
        grid = devs[np.array(order)].reshape(n_host, n_shift, n_row)
    return Mesh(grid, ("host", "shift", "row"))


def pod_spec_check(n_devices: int, n_host: int = 2) -> dict:
    """Compile + run a (host × shift × row) collective program on the
    virtual CPU mesh: per-axis psums with the exact axis roles the pod
    layout uses (row = intra-solve reductions, shift = free axis,
    host = final moment reduction).  Returns the axis sizes checked."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    devs = jax.devices("cpu")[:n_devices]
    n_shift = 2 if n_devices // n_host >= 2 else 1
    n_row = n_devices // n_host // n_shift
    mesh = pod_mesh(n_shift=n_shift, n_row=n_row,
                    devices=np.array(devs).reshape(n_host, -1))
    n = 16 * n_row

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P("row"), P("shift"), P("host")),
             out_specs=(P(), P(), P()))
    def prog(x, s, h):
        # row: intra-solve dot, shift: none, host: moment psum
        dot = jax.lax.psum(jnp.sum(x * x), "row")
        sh = jax.lax.psum(jnp.sum(s), "shift")
        hm = jax.lax.psum(jnp.sum(h), "host")
        return (jnp.broadcast_to(dot, (1,)), jnp.broadcast_to(sh, (1,)),
                jnp.broadcast_to(hm, (1,)))

    x = np.arange(n, dtype=np.float32)
    s = np.arange(4 * n_shift, dtype=np.float32)
    h = np.arange(4 * n_host, dtype=np.float32)
    dot, sh, hm = prog(x, s, h)
    np.testing.assert_allclose(np.asarray(dot)[0], np.sum(x * x), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sh)[0], s.sum(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hm)[0], h.sum(), rtol=1e-6)
    return {"host": n_host, "shift": n_shift, "row": n_row}


__all__ = ["init_multihost", "pod_mesh", "pod_spec_check"]
