"""Scenario-batch sharding over the GPUs of a host.

The reference has no distributed machinery at all (SURVEY.md §2.4) — its
"transport" is one blocking DDS service call (NeoMpcPlanner.cpp:248-250).
Here a fleet batch is split over the cards: MPC scenarios are independent,
so each card steps its own shard and the only communication is the fleet
metrics' reduction.

Design (the standard JAX recipe): a 2-D ('host', 'chip') mesh; the scenario
batch is sharded over both axes flattened; every per-scenario input/state leaf
carries NamedSharding(P(('host', 'chip'))) on its leading axis; the engine step
runs under jit + shard_map, and the returned fleet metrics are the only
cross-device reduction. The mesh follows the algorithm alone: the cards of
one host are joined all to all (NVLink), so one process drives them with
`make_mesh(hosts=1)` — a flat mesh — and a multi-host fleet folds its
process count into the 'host' axis. The design goal is keeping XLA from
inserting any other communication.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MpcConfig
from ..engine import ControlState, controller_step, init_state

__all__ = ["make_mesh", "shard_batch", "FleetMetrics", "ShardedEngine", "initialize_distributed"]


def initialize_distributed(**kw: Any) -> None:
    """Multi-host bring-up: jax.distributed.initialize with graceful no-op when
    already initialized (the §5.8 'failure detection' init barrier)."""
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError:
        pass  # already initialized


def make_mesh(devices: Sequence[jax.Device] | None = None,
              hosts: int | None = None) -> Mesh:
    """Build the ('host', 'chip') mesh. With explicit `hosts`, the device list
    is folded into (hosts, chips_per_host); otherwise process_count is used."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    h = hosts if hosts is not None else max(jax.process_count(), 1)
    if n % h != 0:
        # Silently folding to a 1-host mesh here would quietly stop using
        # the host axis on a multi-host fleet. Fail loudly instead.
        raise ValueError(
            f"{n} devices do not tile over {h} hosts; pass an explicit "
            f"`hosts` that divides the device count")
    import numpy as np

    dev_array = np.asarray(devices).reshape(h, n // h)
    return Mesh(dev_array, ("host", "chip"))


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """Place every leaf with its leading (scenario) axis sharded over the mesh."""

    def put(x):
        x = jnp.asarray(x)
        spec = P(("host", "chip"), *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


class FleetMetrics(NamedTuple):
    """Cross-fleet aggregates — the one place collectives appear.

    Mirrors the observability the reference lacks (SURVEY.md §5 metrics row):
    per-solve cost, solver iterations, convergence and safety-stop rates.
    """

    mean_cost: jnp.ndarray
    max_iters: jnp.ndarray
    converged_frac: jnp.ndarray
    collision_frac: jnp.ndarray
    lethal_frac: jnp.ndarray
    mean_cmd_speed: jnp.ndarray


def _metrics_from(out, axes=None) -> FleetMetrics:
    """Fleet reductions. With `axes` (inside shard_map) the local means are
    pmean/pmax-reduced over the mesh — equal shard sizes make pmean-of-means
    the exact global mean; without axes (plain jit) they are global already."""
    if axes is None:
        mean, mx = jnp.mean, jnp.max
    else:
        mean = lambda x: jax.lax.pmean(jnp.mean(x), axes)
        mx = lambda x: jax.lax.pmax(jnp.max(x), axes)
    return FleetMetrics(
        mean_cost=mean(out.fun),
        max_iters=mx(out.solver_iters),
        converged_frac=mean(out.solver_converged.astype(jnp.float32)),
        collision_frac=mean(out.collision.astype(jnp.float32)),
        lethal_frac=mean(out.lethal.astype(jnp.float32)),
        mean_cmd_speed=mean(jnp.linalg.norm(out.cmd_vel[..., :2], axis=-1)),
    )


class ShardedEngine:
    """Fleet-scale engine: one compiled executable steps B scenarios sharded
    over the mesh and reduces fleet metrics with XLA collectives.

    >>> eng = ShardedEngine(cfg, make_mesh())
    >>> state = eng.init_state(4096)
    >>> out, metrics = eng.step(state, plans, poses, vels, costmaps, fps, dts)

    With donate_state=True (default) the input state buffer is donated to XLA
    each step: always thread `out.state` forward; re-using a donated state
    array raises. Pass donate_state=False for ad-hoc replays of old states.
    """

    def __init__(self, cfg: MpcConfig, mesh: Mesh | None = None,
                 parity: bool = True, donate_state: bool = True,
                 window_cells: int | None = None):
        """window_cells: nav2 rolling-local-costmap fleets — `costmaps` then
        carry each lane's WORLD map (pass them pre-flattened via
        Costmap.with_flat for the once-per-mission relayout) and each step
        re-centers a zero-copy (window_cells,)² view on its lane's robot
        (simulation.rolling_view). Per-lane metadata only — no cross-shard
        communication is introduced."""
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.parity = parity
        self.window_cells = window_cells

        # shard_map (not GSPMD annotations): each device runs the batched
        # step on its LOCAL shard, so the solver's lockstep-tail compaction
        # (sqp.make_sqp_solver_batched) gathers/scatters straggler lanes
        # shard-locally — no cross-device data movement from the re-batching.
        # The only collectives are the metric pmean/pmax reductions.
        # check_vma=False: the vma
        # tracker taints lax.scan carries seeded from in-body constants
        # (rollout's zero pose) even though the body is per-shard pure; the
        # P() out_spec for the metrics is made true by the pmean/pmax.
        from ..engine import make_batched_controller_step

        step_local = make_batched_controller_step(cfg, parity)

        def batch(state, plans, poses, vels, cms, fps, dts):
            if window_cells is not None:
                from ..simulation import rolling_view

                cms = jax.vmap(rolling_view, in_axes=(0, 0, None))(
                    cms, poses, window_cells)
            out = step_local(state, plans, poses, vels, cms, fps, dts)
            return out, _metrics_from(out, axes=("host", "chip"))

        axes = P(("host", "chip"))
        sharded = jax.shard_map(
            batch, mesh=self.mesh,
            in_specs=(axes,) * 7,
            out_specs=(axes, P()),
            check_vma=False,
        )
        donate = (0,) if donate_state else ()
        self._step = jax.jit(sharded, donate_argnums=donate)

    def init_state(self, batch: int) -> ControlState:
        st = init_state(self.cfg)
        st = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), st)
        return shard_batch(st, self.mesh)

    def shard(self, tree):
        return shard_batch(tree, self.mesh)

    def step(self, state, plans, poses, vels, costmaps, footprints, dts):
        return self._step(state, plans, poses, vels, costmaps, footprints, dts)
