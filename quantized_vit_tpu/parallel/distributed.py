"""Multi-host runtime: distributed init, hybrid ICI×DCN meshes, health.

The reference is strictly single-process (SURVEY.md §5: no
torch.distributed / NCCL / MPI anywhere), so this subsystem is new work the
multi-host target requires: process-group bring-up via
`jax.distributed.initialize`, mesh construction that keeps the
model/tensor axes within a host and the data axis across hosts (so
pjit's all-reduces ride the fast fabric), and collective health checks that detect dead or
desynchronized hosts *before* a 30-minute training step hangs on a
collective.

Failure semantics: JAX collectives don't time out on their own — a lost
host stalls every peer. The health check runs a tiny psum with a watchdog
timer; on timeout or value mismatch it raises :class:`HealthCheckError`
with a per-device report so an external supervisor (or `cli/train
--resume`) can restart from the latest checkpoint (opt/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Bring up the JAX process group for multi-host execution.

    No-op (returns False) when running single-process — i.e. no coordinator
    given and none of the cluster env vars (`COORDINATOR_ADDRESS`,
    megascale/GKE autodetection) are set — so single-chip scripts can call
    this unconditionally. Returns True when `jax.distributed.initialize`
    ran.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None \
            and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def create_hybrid_mesh(ici_shape: Sequence[int],
                       dcn_shape: Sequence[int] = (1,),
                       axis_names: Sequence[str] = ("data", "model"),
                       devices=None) -> Mesh:
    """Mesh whose leading axes split over DCN (hosts) and trailing axes over
    ICI (intra-slice links).

    ``dcn_shape`` has one entry per DCN-parallel axis (usually just data),
    ``ici_shape`` the per-slice layout. Falls back to a plain reshape mesh
    when all dcn factors are 1 (single slice / CPU test meshes).
    ``axis_names`` must have len(dcn_shape) + len(ici_shape) - 1 entries
    when the first ICI axis fuses with the last DCN axis, or simply
    len(full shape); here we keep it simple: the full mesh shape is
    ``tuple(dcn_shape) + tuple(ici_shape)`` collapsed where dims pair up —
    callers pass axis_names matching ``dcn_shape + ici_shape``.
    """
    from jax.experimental import mesh_utils

    full_shape = tuple(dcn_shape) + tuple(ici_shape)
    if len(axis_names) != len(full_shape):
        raise ValueError(
            f"axis_names {axis_names} must match dcn+ici shape {full_shape}")
    if all(d == 1 for d in dcn_shape) or devices is not None:
        devs = np.array(devices if devices is not None else jax.devices())
        return Mesh(devs.reshape(full_shape), axis_names=axis_names)
    dev_mesh = mesh_utils.create_hybrid_device_mesh(
        mesh_shape=tuple(ici_shape),
        dcn_mesh_shape=tuple(dcn_shape) + (1,) * (len(ici_shape) - len(dcn_shape)),
    )
    return Mesh(dev_mesh.reshape(full_shape), axis_names=axis_names)


class HealthCheckError(RuntimeError):
    pass


@dataclasses.dataclass
class HealthReport:
    ok: bool
    num_devices: int
    num_processes: int
    latency_s: float
    detail: str = ""


def collective_health_check(mesh: Mesh, timeout_s: float = 60.0
                            ) -> HealthReport:
    """One tiny all-reduce across the whole mesh under a watchdog.

    Every device contributes 1; the psum must return the device count on
    all shards. A hang (dead host, wedged ICI link) trips the watchdog and
    raises; a wrong value (corrupt collective) raises with the observed
    values. Cheap enough to run at job start and between epochs.
    """
    n = mesh.devices.size
    axes = tuple(mesh.axis_names)

    result: dict = {}

    def run():
        try:
            ones = jax.device_put(
                jnp.ones((n,), jnp.float32),
                NamedSharding(mesh, P(axes if len(axes) > 1 else axes[0])))

            @jax.jit
            def allsum(x):
                return jnp.sum(x) * jnp.ones_like(x)

            out = np.asarray(allsum(ones).block_until_ready())
            result["value"] = out
        except Exception as e:  # pragma: no cover - device failure path
            result["error"] = e

    t0 = time.time()
    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout_s)
    dt = time.time() - t0
    if worker.is_alive():
        raise HealthCheckError(
            f"collective health check hung for {timeout_s}s on mesh "
            f"{dict(zip(mesh.axis_names, mesh.devices.shape))} — suspect a "
            f"dead host or wedged interconnect")
    if "error" in result:
        raise HealthCheckError(
            f"collective health check failed: {result['error']}")
    vals = result["value"]
    if not np.allclose(vals, float(n)):
        raise HealthCheckError(
            f"collective returned {vals.tolist()}, expected {float(n)} on "
            f"all shards — desynchronized or corrupt collective")
    return HealthReport(ok=True, num_devices=n,
                        num_processes=jax.process_count(), latency_s=dt)


def assert_same_step(step: int, mesh: Mesh, timeout_s: float = 60.0) -> None:
    """Cross-host agreement check for resume: every process contributes its
    restored step; min must equal max. Catches a host resuming from a stale
    checkpoint (the multi-host analogue of the reference's scan_checkpoint
    picking the latest file, optimizer/utils.py:9-37)."""
    n = mesh.devices.size
    axes = tuple(mesh.axis_names)
    steps = jax.device_put(
        jnp.full((n,), float(step), jnp.float32),
        NamedSharding(mesh, P(axes if len(axes) > 1 else axes[0])))

    @jax.jit
    def minmax(x):
        return jnp.min(x), jnp.max(x)

    lo, hi = minmax(steps)
    if float(lo) != float(hi):
        raise HealthCheckError(
            f"processes disagree on resume step: min={float(lo)} "
            f"max={float(hi)} — stale checkpoint on some host")
