"""Synthetic MPO-700 scenario suite.

The reference was validated only in Gazebo simulation (SURVEY.md §4 — no tests
exist). This module is the in-repo replacement: deterministic, parameterized
scenario batches (plans, obstacle costmaps, footprints, robot states) used by
the oracle parity suite, the benchmarks, and the multi-chip dry run.

Batches are generated with numpy RNG on the host (deterministic per seed,
backend-independent, and much cheaper than tracing large random programs
through a remote device) and land on device as stacked pytrees ready for
vmap/pjit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import MpcConfig
from .engine import ControlState, init_state
from .ops.costmap import Costmap
from .ops.footprint import Footprint
from .ops.pursuit import Plan

__all__ = ["ScenarioBatch", "make_scenario_batch", "mpo700_footprint", "mpo500_footprint"]

# MPO-700 chassis is ~0.73 x 0.55 m; MPO-500 (mecanum) is ~0.99 x 0.67 m —
# the two robot families the reference targets (README.md:6).
MPO700_LENGTH = 0.73
MPO700_WIDTH = 0.55
MPO500_LENGTH = 0.99
MPO500_WIDTH = 0.67

# Gaussian-blob obstacle width (variance, m²) — the ONE definition shared by
# blob_maps (device), make_scenario_batch's host synthesis, and
# simulation.py's incremental-update patch synthesis: the update regime's
# "sensor belief" patches must match the full-map regimes cell-for-cell.
BLOB_SIGMA2 = 0.08


def mpo700_footprint(max_vertices: int = 8) -> Footprint:
    return Footprint.rectangle(MPO700_LENGTH, MPO700_WIDTH, max_vertices)


def mpo500_footprint(max_vertices: int = 8) -> Footprint:
    return Footprint.rectangle(MPO500_LENGTH, MPO500_WIDTH, max_vertices)


from functools import partial


def blob_maps(centers, amp, map_size: int, resolution: float,
              lethal_threshold: float | None = None,
              origin=None) -> jnp.ndarray:
    """Synthesize (B, H, W) obstacle maps on device: max of Gaussian blobs,
    optional exact-lethal saturation. centers: (B, O, 2) world coords of the
    blob centers; origin: (B, 2) world coords of cell (0, 0)'s corner (None =
    window centered on the world origin). Traceable — usable inside a scan
    for per-tick dynamic obstacles (the reference's loop receives a fresh
    costmap every service call; this is the batched equivalent)."""
    half = map_size * resolution / 2.0
    c = (jnp.arange(map_size, dtype=jnp.float32) * resolution
         + resolution / 2)
    if origin is None:
        origin = jnp.full((centers.shape[0], 2), -half, jnp.float32)
    xw = origin[:, 0, None] + c[None, :]          # (B, W) cell-center x
    yw = origin[:, 1, None] + c[None, :]          # (B, H) cell-center y
    batch, n_obstacles = amp.shape
    sig2 = BLOB_SIGMA2

    def blob(i, acc):
        d2 = ((xw[:, None, :] - centers[:, i, 0, None, None]) ** 2
              + (yw[:, :, None] - centers[:, i, 1, None, None]) ** 2)
        return jnp.maximum(acc, amp[:, i, None, None]
                           * jnp.exp(-d2 / (2 * sig2)))

    data = jax.lax.fori_loop(
        0, n_obstacles, blob,
        jnp.zeros((batch, map_size, map_size), jnp.float32))
    data = jnp.clip(data, 0.0, 1.0)
    if lethal_threshold is not None:
        data = jnp.where(data > lethal_threshold, 1.0, data)
    return data


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _blob_maps_device(centers, amp, corridor_pts, map_size, resolution,
                      lethal_threshold, clear_corridor_m, corridor_max_cost):
    """Device twin of the host blob-map synthesis (blob_maps above, on
    window-local coordinates) plus the optional corridor clamp. Inputs are
    the tiny host-drawn parameter arrays; the (B, H, W) grids never cross
    the link. Accumulates over obstacles/plan points with fori_loop so peak
    memory stays O(B·H·W) instead of O(B·O·H·W)."""
    half = map_size * resolution / 2.0
    c = (jnp.arange(map_size, dtype=jnp.float32) * resolution
         - half + resolution / 2)
    xx = jnp.broadcast_to(c[None, :], (map_size, map_size))  # x along axis 1
    yy = jnp.broadcast_to(c[:, None], (map_size, map_size))
    data = blob_maps(centers, amp, map_size, resolution, lethal_threshold)
    batch = amp.shape[0]
    if corridor_pts is not None:
        def near(i, acc):
            d2p = ((xx[None] - corridor_pts[:, i, 0, None, None]) ** 2
                   + (yy[None] - corridor_pts[:, i, 1, None, None]) ** 2)
            return jnp.minimum(acc, d2p)

        mind2 = jax.lax.fori_loop(
            0, corridor_pts.shape[1], near,
            jnp.full((batch, map_size, map_size), jnp.inf, jnp.float32))
        data = jnp.where(mind2 < jnp.float32(clear_corridor_m) ** 2,
                         jnp.minimum(data, jnp.float32(corridor_max_cost)),
                         data)
    return data


class ScenarioBatch(NamedTuple):
    state: ControlState       # (B, ...) control state
    plan: Plan                # (B, P, 3)
    robot_pose: jnp.ndarray   # (B, 3)
    current_vel: jnp.ndarray  # (B, 3)
    costmap: Costmap          # (B, H, W)
    footprint: Footprint      # (B, V, 2)
    delta_t: jnp.ndarray      # (B,)


def make_scenario_batch(
    cfg: MpcConfig,
    batch: int,
    seed: int = 0,
    map_size: int = 120,
    resolution: float = 0.05,
    n_obstacles: int = 6,
    plan_points: int = 64,
    lethal_threshold: float | None = None,
    pose_jitter: float = 0.05,
    plan_length_range: tuple[float, float] = (1.5, 3.0),
    clear_corridor_m: float | None = None,
    corridor_max_cost: float = 0.6,
    center_on: str = "start",
    maps_on_device: bool = False,
    footprint: Footprint | None = None,
) -> ScenarioBatch:
    """Random curved plans + Gaussian-blob obstacle maps + perturbed starts.

    Covers the BASELINE.json batch axes: per-scenario obstacle layouts and
    lookahead geometry (weight grids batch by building several configs).

    lethal_threshold: when set, blob cells above it saturate to exactly 1.0 —
    maps then contain true lethal regions so the exact-equality branches
    (point ×1000 py:257-260, footprint term py:262-263) are reachable.
    pose_jitter: start-pose spread; widen it to push some footprints against
    obstacles.
    plan_length_range: arc-length bounds. The default produces goals that can
    exceed a small fixed map window (a real deployment's local costmap ROLLS
    with the robot; this sim's map is static) — for goal-REACHING studies pick
    lengths that keep plan + footprint inside the window, e.g. (0.7, 1.1) on
    a 3.2 m map.
    clear_corridor_m: when set, cells within this distance of the plan
    polyline are clamped to corridor_max_cost. This reproduces the contract a
    global planner gives a local controller — the plan's swept corridor is
    collision-free (obstacles may still crowd its edges) — so closed-loop
    goal-reaching measures CONTROLLER quality instead of counting lanes whose
    randomly-sampled blob happens to wall off the corridor entirely. Pick
    >= the footprint circumradius (MPO-700: 0.46 m) plus tracking margin.
    corridor_max_cost: ceiling applied inside the corridor; keep it below the
    slow-down gate (200/255 ~ 0.784) and the collision latch (0.99).
    center_on: where the (static) local window sits. "start" centers it on
    the robot start (the window edge then sits one half-extent PAST the
    start, so long plans — or even a small overshoot's footprint corner at
    a ~1 m goal on a 3.2 m window — hit the lethal out-of-window band).
    "plan" centers it on the plan's bounding box, the closest static
    approximation of a deployment's rolling local costmap: margin is
    symmetric about the whole maneuver instead of the start pose.
    maps_on_device: synthesize the costmap grids ON DEVICE from the
    host-drawn blob parameters instead of uploading finished (B, H, W)
    arrays (a 4096-lane 64² batch is 67 MB; only the (B, O, ·) parameters
    travel, and the host does no per-cell work). Maps
    are numerically equivalent but not bit-identical to the host path
    (float32 device exp/sum vs numpy float64); scenario CONTENT (plans,
    poses, obstacle layout) is identical either way, so fidelity suites
    keep the host path and scale benchmarks use this one.
    """
    rng = np.random.default_rng(seed)

    # --- plans: arcs with random curvature/length, starting at the origin ---
    curv = rng.uniform(-0.6, 0.6, batch)
    length = rng.uniform(*plan_length_range, batch)
    s = np.linspace(0.0, 1.0, plan_points)[None, :] * length[:, None]  # (B, P)
    yaw = curv[:, None] * s
    safe_curv = np.where(np.abs(curv[:, None]) > 1e-6, curv[:, None], 1.0)
    xs = np.where(np.abs(curv[:, None]) > 1e-6, np.sin(yaw) / safe_curv, s)
    ys = np.where(np.abs(curv[:, None]) > 1e-6, (1.0 - np.cos(yaw)) / safe_curv,
                  np.zeros_like(s))
    poses = np.stack([xs, ys, yaw], axis=-1).astype(np.float32)  # (B, P, 3)
    pad = cfg.max_plan_points - plan_points
    if pad < 0:
        raise ValueError("plan_points exceeds cfg.max_plan_points")
    poses = np.concatenate(
        [poses, np.repeat(poses[:, -1:, :], pad, axis=1)], axis=1
    )
    plan = Plan.from_poses(jnp.asarray(poses),
                           jnp.full((batch,), plan_points, jnp.int32))

    # --- costmaps: max of Gaussian blobs away from the start pose ---
    half = map_size * resolution / 2.0
    yy, xx = np.meshgrid(
        np.arange(map_size, dtype=np.float32) * resolution - half + resolution / 2,
        np.arange(map_size, dtype=np.float32) * resolution - half + resolution / 2,
        indexing="ij",
    )
    # Per-lane window-center shift (world coords). xx/yy and everything
    # sampled below stay window-local; world = local + shift.
    if center_on == "plan":
        ext = poses[:, :plan_points, :2]
        shift = ((ext.min(axis=1) + ext.max(axis=1)) / 2.0).astype(np.float32)
    elif center_on == "start":
        shift = np.zeros((batch, 2), np.float32)
    else:
        raise ValueError(f"center_on must be 'start' or 'plan': {center_on!r}")
    centers = rng.uniform(-half + 0.8, half - 0.3, (batch, n_obstacles, 2))
    # keep a clear bubble around the robot start (world ~ origin)
    centers = np.where(
        np.linalg.norm(centers + shift[:, None, :], axis=-1, keepdims=True)
        < 0.8,
        centers + 1.2, centers,
    )
    amp = rng.uniform(0.3, 0.95, (batch, n_obstacles))
    corridor_pts = None
    if clear_corridor_m is not None:
        # Window-local plan coords (world - shift) to match the cell grid;
        # plan points are ~resolution-spaced, so min POINT distance over
        # every 2nd pose ~= polyline distance at this radius.
        corridor_pts = (poses[:, :plan_points:2, :2]
                        - shift[:, None, :]).astype(np.float32)  # (B, P', 2)
    if maps_on_device:
        data = _blob_maps_device(
            jnp.asarray(centers, jnp.float32), jnp.asarray(amp, jnp.float32),
            None if corridor_pts is None else jnp.asarray(corridor_pts),
            map_size, resolution, lethal_threshold, clear_corridor_m,
            corridor_max_cost)
    else:
        sig2 = BLOB_SIGMA2
        d2 = ((xx[None, None] - centers[..., 0, None, None]) ** 2
              + (yy[None, None] - centers[..., 1, None, None]) ** 2)  # (B, O, H, W)
        blobs = amp[..., None, None] * np.exp(-d2 / (2 * sig2))
        data = np.clip(np.max(blobs, axis=1), 0.0, 1.0).astype(np.float32)
        if lethal_threshold is not None:
            data = np.where(data > lethal_threshold, 1.0,
                            data).astype(np.float32)
        if corridor_pts is not None:
            # Chunk lanes to bound the (C, H*W, P') distance tensor.
            cx = xx.reshape(-1).astype(np.float32)  # x varies along axis 1
            cy = yy.reshape(-1).astype(np.float32)
            r2 = np.float32(clear_corridor_m) ** 2
            chunk = max(1, (1 << 25) // (cx.size * corridor_pts.shape[1]))
            for i in range(0, batch, chunk):
                p = corridor_pts[i:i + chunk]  # (C, P', 2)
                d2p = ((cx[None, :, None] - p[:, None, :, 0]) ** 2
                       + (cy[None, :, None] - p[:, None, :, 1]) ** 2).min(-1)
                near = (d2p < r2).reshape(-1, map_size, map_size)
                data[i:i + chunk] = np.where(
                    near, np.minimum(data[i:i + chunk],
                                     np.float32(corridor_max_cost)),
                    data[i:i + chunk])
        data = jnp.asarray(data)
    costmap = Costmap(
        data=data,
        origin=jnp.asarray(shift - half, jnp.float32),
        resolution=jnp.full((batch,), resolution, jnp.float32),
    )

    # --- robot state ---
    robot_pose = jnp.asarray(
        rng.uniform(-pose_jitter, pose_jitter, (batch, 3)), jnp.float32)
    current_vel = jnp.asarray(rng.uniform(-0.3, 0.3, (batch, 3)), jnp.float32)

    fp1 = (footprint if footprint is not None
           else mpo700_footprint(cfg.max_footprint_vertices))
    footprint = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), fp1)

    state1 = init_state(cfg)
    state = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), state1)

    delta_t = jnp.full((batch,), 1.0 / cfg.controller_frequency, jnp.float32)

    return ScenarioBatch(state=state, plan=plan, robot_pose=robot_pose,
                         current_vel=current_vel, costmap=costmap,
                         footprint=footprint, delta_t=delta_t)
