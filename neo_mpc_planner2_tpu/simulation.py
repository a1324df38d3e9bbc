"""Device-resident closed-loop FollowPath simulation.

BASELINE.json's last config is "full FollowPath loop at 50 Hz" over 4096+
scenarios. The reference could only do this one robot at a time against Gazebo;
here the whole loop — controller tick (pursuit + solve + post-processing) plus
the robot plant (the same omni kinematic model, mpc_optimization_server.py:
230-236) — runs as one `lax.scan` on device, vmap-able over scenario batches
and shardable over the mesh. No host round-trips inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import MpcConfig
from .engine import ControlState, controller_step, init_state
from .ops.costmap import (Costmap, extract_window_onehot, u8_source_enabled,
                          world_to_map)
from .ops.footprint import Footprint
from .ops.pursuit import Plan
from .ops.rollout import rollout

__all__ = ["SimResult", "simulate_follow_path", "batch_simulate",
           "rolling_window", "rolling_view"]


def rolling_window(world: Costmap, pose: jnp.ndarray, cells: int) -> Costmap:
    """Extract the (cells, cells) local window of a larger WORLD costmap,
    centered on the robot and clamped fully inside the world bounds.

    This is nav2's rolling local costmap (Costmap2DROS rolling_window): the
    controller only ever sees a fixed-size window that re-centers on the
    robot every tick, so plan pruning (half the window extent,
    NeoMpcPlanner.cpp:80-82) and the lethal out-of-window band keep their
    deployment semantics while the robot traverses arbitrarily long plans.
    world: single-lane (H, W) Costmap; vmap for batches. pose: (3,).

    MATERIALIZING variant (dynamic_slice copy per call). The closed-loop
    simulators default to the zero-copy `rolling_view` below — identical
    sampling semantics without the per-tick copy; this slice form remains
    for hosts that need a standalone window array (e.g. to hand to the
    native front-end) and as the equivalence oracle for the view."""
    H, W = world.data.shape[-2], world.data.shape[-1]
    mx, my = world_to_map(world, pose[0], pose[1])
    sx = jnp.clip(mx - cells // 2, 0, W - cells)
    sy = jnp.clip(my - cells // 2, 0, H - cells)
    data = jax.lax.dynamic_slice(world.data, (sy, sx), (cells, cells))
    origin = world.origin + jnp.stack([sx, sy]) * world.resolution
    return Costmap(data=data, origin=origin, resolution=world.resolution)


def rolling_view(world: Costmap, pose: jnp.ndarray, cells: int) -> Costmap:
    """ZERO-COPY rolling window: the same nav2 semantics as `rolling_window`
    — identical window placement (robot-centered, clamped inside the world),
    identical in-window values, identical lethal out-of-window band — but as
    BOUNDS METADATA on the world map (Costmap.win_lo/win_cells) instead of a
    materialized slice. Samplers read the world map's (hoisted) flat view in
    place, so the per-tick per-lane dynamic_slice copy + re-flatten
    disappears. world: any leading batch dims; pose
    broadcasts accordingly when vmapped."""
    H, W = world.data.shape[-2], world.data.shape[-1]
    mx, my = world_to_map(world, pose[0], pose[1])
    sx = jnp.clip(mx - cells // 2, 0, W - cells)
    sy = jnp.clip(my - cells // 2, 0, H - cells)
    return world.replace(win_lo=jnp.stack([sx, sy], axis=-1),
                         win_cells=cells)


class SimResult(NamedTuple):
    poses: jnp.ndarray        # (T, 3) robot trajectory (world frame)
    cmds: jnp.ndarray         # (T, 3) commanded velocities
    collisions: jnp.ndarray   # (T,) bool predicted-collision latch
    lethal: jnp.ndarray       # (T,) bool plugin hard-stop flag
    goal_dist: jnp.ndarray    # (T,) distance to the plan goal
    converged: jnp.ndarray    # (T,) bool solver converged this tick
    solver_iters: jnp.ndarray  # (T,) SQP iterations spent this tick
    final_state: ControlState
    # costmap_updates regime only: the carried per-lane world map AFTER the
    # run's dirty-window writes (None otherwise). Chain segments with
    # batch_simulate(..., init=..., init_costmap=res.final_costmap) —
    # rebuilding the carry from the pristine scenario_batch.costmap would
    # silently discard every update the previous segment painted.
    final_costmap: Costmap | None = None


def simulate_follow_path(
    cfg: MpcConfig,
    plan: Plan,
    costmap: Costmap,
    footprint: Footprint,
    start_pose: jnp.ndarray,
    start_vel: jnp.ndarray,
    n_ticks: int,
    parity: bool = True,
    window_cells: int | None = None,
    window_view: bool = True,
) -> SimResult:
    """Run n_ticks of the 1/controller_frequency control loop, integrating the
    command with the same kinematic model the controller assumes.

    window_cells: when set, `costmap` is the WORLD map and the controller
    sees only the (window_cells,)² rolling window re-centered on the robot
    each tick (nav2 rolling local costmap semantics). window_view selects
    the zero-copy bounds-metadata view (default; see rolling_view) vs the
    materializing dynamic_slice per tick (the equivalence oracle)."""
    dt = jnp.float32(cfg.control_interval)
    # Resolve the u8 gather-source knob against the map the solver samples:
    # the world map for the zero-copy view (it IS the gather source), the
    # window for the materializing slice.
    world_cells = costmap.data.shape[-2] * costmap.data.shape[-1]
    sampled_cells = (window_cells * window_cells
                     if window_cells is not None and not window_view
                     else world_cells)
    u8 = u8_source_enabled(cfg.solver_costmap_u8, sampled_cells)
    # Flat-view hoist: once per run, not once per tick (see batch_simulate).
    if window_cells is None or window_view:
        if costmap.flat is None or (u8 and costmap.flat_u8 is None):
            costmap = costmap.with_flat(u8=u8)

    def tick(carry, _):
        state, pose, vel = carry
        if window_cells is None:
            cm = costmap
        elif window_view:
            cm = rolling_view(costmap, pose, window_cells)
        else:
            # Re-centered window is fresh data every tick; flatten it here so
            # the solver loop's gather view isn't re-materialized per trip.
            cm = rolling_window(costmap, pose, window_cells).with_flat(u8=u8)
        out = controller_step(cfg, state, plan, pose, vel, cm, footprint,
                              dt, parity=parity)
        cmd = out.cmd_vel
        # Plant: one step of the omni model (py:230-236 semantics).
        new_pose = rollout(cmd[None, :], dt, pose)[0]
        goal = plan.goal()
        gd = jnp.linalg.norm(new_pose[:2] - goal[:2])
        return (out.state, new_pose, cmd), (new_pose, cmd, out.collision,
                                            out.lethal, gd,
                                            out.solver_converged,
                                            out.solver_iters)

    init = (init_state(cfg), jnp.asarray(start_pose, jnp.float32),
            jnp.asarray(start_vel, jnp.float32))
    (fin_state, _, _), (poses, cmds, cols, lethal, gd, conv, iters) = \
        jax.lax.scan(tick, init, None, length=n_ticks)
    return SimResult(poses=poses, cmds=cmds, collisions=cols, lethal=lethal,
                     goal_dist=gd, converged=conv, solver_iters=iters,
                     final_state=fin_state)


def batch_simulate(cfg: MpcConfig, scenario_batch, n_ticks: int,
                   parity: bool = True, init=None,
                   window_cells: int | None = None,
                   window_view: bool = True,
                   dynamic_obstacles=None,
                   obstacle_lethal_threshold: float | None = None,
                   costmap_updates=None,
                   update_cells: int = 16,
                   init_costmap: Costmap | None = None,
                   solver_batch=None,
                   ) -> SimResult:
    """Closed-loop sim over a ScenarioBatch (scenarios.py), batch-first.

    Structured as lax.scan over the BATCHED tick (make_batched_controller_step)
    rather than vmap over per-lane scans: identical per-lane math, but the
    solver's lockstep-tail compaction needs the batch axis visible inside each
    tick. Output leaves keep the (B, T, ...) layout of the original
    vmap-of-scan formulation.

    init: optional (state, pose, vel) carry from a previous segment (e.g. the
    SimResult's final_state + poses[:, -1] + cmds[:, -1]), letting callers
    extend a run without recompiling for a larger static n_ticks.

    window_cells: when set, scenario_batch.costmap is the per-lane WORLD map
    and each tick the controller sees the (window_cells,)² rolling window
    re-centered on its lane's robot (nav2 rolling local costmap semantics).
    window_view (default True) implements it as the ZERO-COPY bounds view
    (rolling_view: world flat views hoisted once, no per-tick copy);
    False keeps the materializing dynamic_slice per tick (the equivalence
    oracle for the view; costs a window copy + re-flatten per lane per
    tick).

    dynamic_obstacles: optional (centers (B, O, 2), amp (B, O),
    vel (B, O, 2)) blob parameters in WORLD coordinates. The costmap is then
    re-synthesized ON DEVICE every tick with the centers advanced linearly
    (centers + t·dt·vel) — the batched equivalent of the fresh costmap the
    reference's server receives with every service call, and the scenario
    class the 3 s stuck-wait (py:374-382) exists for: latch on a crossing
    obstacle, outwait it, resume. scenario_batch.costmap supplies the grid
    geometry (shape/origin/resolution); obstacle_lethal_threshold saturates
    blob cells above it to exactly 1.0. Mutually exclusive with
    window_cells; the tick clock restarts at 0 per call, so don't chain
    dynamic runs through `init` expecting obstacle continuity.

    costmap_updates: optional (centers (B, 2), amp (B,), vel (B, 2)) — the
    INCREMENTAL-update dynamic regime (round-3 verdict item 2): instead of
    re-synthesizing the whole grid per tick, each lane's map receives one
    (update_cells,)² dirty-window write per tick (Costmap.update_window)
    covering its moving obstacle — the window contents are max(static base,
    moving blob), i.e. what a sensor pipeline would publish for that patch.
    The map state is carried across ticks with its hoisted flat/u8 views
    refreshed in place, so the engine pays only the dirty write, not a full
    re-flatten — this is the deployment pattern of nav2's live local costmap
    (the reference's Costmap2d subscription, py:118). Composes with
    window_cells (zero-copy view over the carried, updated world map);
    mutually exclusive with dynamic_obstacles. The updated world map is
    returned as SimResult.final_costmap — to chain segments through `init`,
    also pass init_costmap=res.final_costmap (else the next segment's
    carried map restarts from the pristine base and loses every painted
    cell). scenario_batch.costmap stays the STATIC BASE BELIEF the patches
    repaint from in both segments, so the chain is bit-identical to one
    longer run. Like dynamic_obstacles, the tick clock restarts at 0 per
    call — advance the obstacle centers yourself when chaining
    (centers + n_ticks·dt·vel).

    init_costmap: optional carried-map resume handle (a previous segment's
    SimResult.final_costmap); costmap_updates regime only.
    """
    from .engine import make_batched_controller_step

    sb = scenario_batch
    # solver_batch: optional batched solver override (e.g. the prox-FISTA
    # product path, jax.vmap(solver.make_solver(...))) — forwarded to
    # make_batched_controller_step; None keeps the parity SQP.
    step = make_batched_controller_step(cfg, parity=parity,
                                        solver_batch=solver_batch)
    # The map is fixed for the whole run: materialize the flat view ONCE
    # outside the tick scan (inside, XLA can re-run the relayout every tick —
    # a 64 MB copy per tick at batch 4096).
    costmap = sb.costmap
    world_cells = costmap.data.shape[-2] * costmap.data.shape[-1]
    sampled_cells = (window_cells * window_cells
                     if window_cells is not None and not window_view
                     else world_cells)
    u8 = u8_source_enabled(cfg.solver_costmap_u8, sampled_cells)
    if window_cells is not None and not window_view:
        # materializing slice mode: windows (re-)flatten per tick — never
        # build (and then throw away) whole-world flat/u8 views here.
        costmap = sb.costmap.replace(flat=None, flat_u8=None)
    elif costmap.flat is None or (u8 and costmap.flat_u8 is None):
        costmap = costmap.with_flat(u8=u8)
    if dynamic_obstacles is not None:
        if window_cells is not None:
            raise ValueError(
                "dynamic_obstacles and window_cells are mutually exclusive")
        if costmap_updates is not None:
            raise ValueError(
                "dynamic_obstacles and costmap_updates are mutually exclusive")
        h, w = sb.costmap.data.shape[-2], sb.costmap.data.shape[-1]
        if h != w:
            raise ValueError("dynamic_obstacles needs a square grid")
        # blob_maps shares ONE cell-center grid built from lane 0's
        # resolution; per-lane resolutions would silently paint lane k's
        # obstacles at wrong world positions (sampling uses each lane's own
        # resolution). Reject heterogeneous batches when the values are
        # concrete (under an outer jit they are tracers — the precondition
        # then rests on the caller, as documented here).
        res_arr = sb.costmap.resolution
        if not isinstance(res_arr, jax.core.Tracer):
            rnp = np.asarray(res_arr)
            if rnp.ndim and not np.all(rnp == rnp.flat[0]):
                raise ValueError("dynamic_obstacles requires one shared "
                                 "resolution across the batch")
        dyn_centers, dyn_amp, dyn_vel = dynamic_obstacles
    if costmap_updates is not None:
        if window_cells is not None and not window_view:
            raise ValueError("costmap_updates needs the zero-copy window "
                             "view (window_view=True)")
        upd_c, upd_a, upd_v = costmap_updates
        U = int(update_cells)
        H_m, W_m = costmap.data.shape[-2], costmap.data.shape[-1]
        if U > min(H_m, W_m):
            raise ValueError("update_cells exceeds the map")
        base_data = costmap.data  # static base belief (never mutated)
    batch = sb.robot_pose.shape[0]
    dt = jnp.float32(cfg.control_interval)
    dts = jnp.full((batch,), dt)
    goals = jax.vmap(lambda p: p.goal())(sb.plan)

    if init is None:
        state0 = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,) + x.shape), init_state(cfg))
        pose0 = jnp.asarray(sb.robot_pose, jnp.float32)
        vel0 = jnp.asarray(sb.current_vel, jnp.float32)
    else:
        state0, pose0, vel0 = init

    def tick(carry, t):
        if costmap_updates is not None:
            state, pose, vel, cm_carry = carry
            # One dirty-window write per lane: repaint the (U, U) patch
            # around the obstacle's CURRENT center with max(static base,
            # blob) — a sensor pipeline's belief for that patch. The hoisted
            # flat/u8 views refresh in place inside update_window.
            ct = upd_c + (t.astype(jnp.float32) * dt)[..., None] * upd_v
            res = cm_carry.resolution          # (B,)
            ox = cm_carry.origin[:, 0]
            oy = cm_carry.origin[:, 1]
            cx = jnp.clip(jnp.int32(jnp.floor((ct[:, 0] - ox) / res)) - U // 2,
                          0, W_m - U)
            cy = jnp.clip(jnp.int32(jnp.floor((ct[:, 1] - oy) / res)) - U // 2,
                          0, H_m - U)
            idx = jnp.arange(U, dtype=jnp.float32)
            wxs = (ox[:, None] + (cx[:, None].astype(jnp.float32) + idx)
                   * res[:, None] + res[:, None] / 2)        # (B, U)
            wys = (oy[:, None] + (cy[:, None].astype(jnp.float32) + idx)
                   * res[:, None] + res[:, None] / 2)
            d2 = ((wxs[:, None, :] - ct[:, 0, None, None]) ** 2
                  + (wys[:, :, None] - ct[:, 1, None, None]) ** 2)  # (B, U, U)
            from .scenarios import BLOB_SIGMA2
            blob = jnp.clip(upd_a[:, None, None]
                            * jnp.exp(-d2 / (2 * BLOB_SIGMA2)), 0.0, 1.0)
            # One-hot window extraction, not vmapped dynamic_slice: the
            # batched slice lowers to a gather (see extract_window_onehot;
            # the plain form is still to A/B on a GPU).
            base_win = jax.vmap(
                lambda d, y, x: extract_window_onehot(d, y, x, U, U))(
                base_data, cy, cx)
            val = jnp.maximum(base_win, blob)
            if obstacle_lethal_threshold is not None:
                val = jnp.where(val > obstacle_lethal_threshold, 1.0, val)
            cm_carry = jax.vmap(lambda c, b, l: c.update_window(b, l))(
                cm_carry, val, jnp.stack([cx, cy], axis=-1))
            if window_cells is None:
                cm = cm_carry
            else:
                cm = jax.vmap(rolling_view, in_axes=(0, 0, None))(
                    cm_carry, pose, window_cells)
        else:
            state, pose, vel = carry
            if dynamic_obstacles is not None:
                from .scenarios import blob_maps
                ct = dyn_centers + (t.astype(jnp.float32) * dt)[..., None,
                                                                None] * dyn_vel
                data = blob_maps(ct, dyn_amp, sb.costmap.data.shape[-1],
                                 sb.costmap.resolution[0],
                                 obstacle_lethal_threshold,
                                 origin=sb.costmap.origin)
                cm = Costmap(data=data, origin=sb.costmap.origin,
                             resolution=sb.costmap.resolution).with_flat(u8=u8)
            elif window_cells is None:
                cm = costmap
            elif window_view:
                cm = jax.vmap(rolling_view, in_axes=(0, 0, None))(
                    costmap, pose, window_cells)
            else:
                cm = jax.vmap(rolling_window, in_axes=(0, 0, None))(
                    costmap, pose, window_cells).with_flat(u8=u8)
        out = step(state, sb.plan, pose, vel, cm, sb.footprint, dts)
        cmd = out.cmd_vel
        new_pose = jax.vmap(lambda c, p: rollout(c[None, :], dt, p)[0])(cmd, pose)
        gd = jnp.linalg.norm(new_pose[:, :2] - goals[:, :2], axis=-1)
        new_carry = ((out.state, new_pose, cmd, cm_carry)
                     if costmap_updates is not None
                     else (out.state, new_pose, cmd))
        return new_carry, (new_pose, cmd, out.collision,
                           out.lethal, gd,
                           out.solver_converged,
                           out.solver_iters)

    if costmap_updates is not None:
        # The carried world map: broadcast shared origin/resolution shapes to
        # per-lane if needed is already the ScenarioBatch layout; carry the
        # hoisted-flat map so updates refresh it in place across ticks.
        # init_costmap resumes a previous segment's carried map (its hoisted
        # views come along) while base_data above stays the pristine belief.
        if init_costmap is not None:
            # The update windows are indexed from the CARRIED map's
            # origin/resolution while base windows read base_data from
            # scenario_batch.costmap — a geometry-mismatched resume handle
            # would gather cells from the wrong frame with no error. Shapes
            # are static, so at least that much is checked here; keep the
            # origin/resolution identical too (they are traced values).
            if init_costmap.data.shape != costmap.data.shape:
                raise ValueError(
                    f"init_costmap shape {init_costmap.data.shape} != "
                    f"scenario costmap shape {costmap.data.shape}")
            if init_costmap.flat is None or (u8 and init_costmap.flat_u8
                                             is None):
                init_costmap = init_costmap.with_flat(u8=u8)
        init_carry = (state0, pose0, vel0,
                      costmap if init_costmap is None else init_costmap)
    elif init_costmap is not None:
        raise ValueError("init_costmap is only meaningful with "
                         "costmap_updates")
    else:
        init_carry = (state0, pose0, vel0)
    fin, outs = jax.lax.scan(tick, init_carry, jnp.arange(n_ticks))
    fin_state = fin[0]
    # scan stacks time first: (T, B, ...) -> (B, T, ...).
    poses, cmds, cols, lethal, gd, conv, iters = jax.tree.map(
        lambda a: jnp.moveaxis(a, 0, 1), outs)
    return SimResult(poses=poses, cmds=cmds, collisions=cols, lethal=lethal,
                     goal_dist=gd, converged=conv, solver_iters=iters,
                     final_state=fin_state,
                     final_costmap=(fin[3] if costmap_updates is not None
                                    else None))
