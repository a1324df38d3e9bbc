"""Footprint polygon collision cost on device.

Device replacement for two reference pieces:

- nav2 `FootprintCollisionChecker::footprintCostAtPose` called from the C++
  plugin on the raw 0-255 scale (NeoMpcPlanner.cpp:218-219, :332-333);
- `Costmap2d.getFootprintCost(Polygon)` on the normalized [0,1] scale called
  from the Python server (mpc_optimization_server.py:262, :343), whose
  `LineIterator` walks each polygon edge and takes the max cell cost.

Instead of a sequential Bresenham walk per edge (data-dependent trip counts —
hostile to XLA), every edge is sampled at `samples` equally spaced points
(static shape), all points are gathered from the costmap in one vectorized
lookup, and the max is reduced. With `samples` chosen so the sample spacing is
below the map resolution this visits a superset of the Bresenham cells' centers
and yields the same max on the maps used here; the oracle uses the identical
sampling so parity tests are exact by construction.

The polygon is padded to a static vertex count with an explicit valid count so
footprints of different robots batch together.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .costmap import Costmap, cost_at_cell, cost_at_world, cost_at_world_onehot
from .se2 import se2_apply
from ..utils import struct

__all__ = ["Footprint", "transform_footprint", "footprint_cost",
           "footprint_cost_at_pose", "line_cost_exact", "required_edge_samples"]


@struct.dataclass
class Footprint:
    """Padded polygon. vertices: (V, 2); n_valid: () int32 (<= V)."""

    vertices: jnp.ndarray
    n_valid: jnp.ndarray

    @staticmethod
    def create(points, max_vertices: int = 8) -> "Footprint":
        pts = jnp.asarray(points, jnp.float32)
        n = pts.shape[0]
        if n > max_vertices:
            raise ValueError(f"footprint has {n} vertices > max {max_vertices}")
        pad = jnp.zeros((max_vertices - n, 2), jnp.float32) + pts[-1]
        return Footprint(
            vertices=jnp.concatenate([pts, pad], axis=0),
            n_valid=jnp.asarray(n, jnp.int32),
        )

    @staticmethod
    def rectangle(length: float, width: float, max_vertices: int = 8) -> "Footprint":
        """Axis-aligned rectangle centered on base_link (MPO-700-style box)."""
        hl, hw = length / 2.0, width / 2.0
        return Footprint.create(
            [[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]], max_vertices
        )


def transform_footprint(pose: jnp.ndarray, fp: Footprint) -> Footprint:
    """Rigidly place the footprint at pose [x, y, yaw].

    Product-mode equivalent of the intended (but aliased-away, SURVEY.md §2.3 /
    config.CompatConfig.footprint_alias_noop) vertex rotation at
    mpc_optimization_server.py:238-244.
    """
    return fp.replace(vertices=se2_apply(pose, fp.vertices))


def required_edge_samples(points, resolution: float, minimum: int = 8) -> int:
    """Samples-per-edge needed so the uniform sampling spacing stays at or
    below the map resolution for every edge of the (concrete, host-side)
    polygon — the safe static count for `footprint_cost` in "gather"/"onehot"
    mode (an ADVICE round-1 finding: a fixed count under-samples long edges,
    skipping cells the reference's LineIterator would visit)."""
    import numpy as np

    pts = np.asarray(points, float)
    edges = np.roll(pts, -1, axis=0) - pts
    max_edge = float(np.max(np.linalg.norm(edges, axis=-1)))
    return max(minimum, int(np.ceil(max_edge / float(resolution))) + 2)


def line_cost_exact(cm: Costmap, x0, y0, x1, y1) -> jnp.ndarray:
    """Max cell cost along a segment via an exact Amanatides-Woo grid walk —
    the device twin of the native host's `line_cost`
    (native/src/neo_mpc_host.cpp:105-150), itself the nav2
    FootprintCollisionChecker::lineCost pattern.

    Every cell the segment crosses is visited (a superset of Bresenham's
    cells), so no lethal cell can be skipped regardless of edge length — the
    cell-exact alternative to uniform edge sampling. All endpoints may be
    batched: x0/y0/x1/y1 broadcast together to any shape.

    Static trip count: an in-bounds traversal crosses at most (W-1)+(H-1)
    boundaries, so the `lax.scan` runs H+W steps. A segment whose endpoint
    cell lies outside the map would need more steps, but it necessarily
    crosses out-of-bounds (lethal 1.0) territory — handled by folding 1.0
    into the max whenever either endpoint cell is out of bounds (the rectangle
    is convex, so two in-bounds endpoints never leave the map).
    """
    from .costmap import grid_bounds, grid_origin, world_to_map

    h, w = cm.data.shape[-2], cm.data.shape[-1]
    res = cm.resolution
    # Effective (window) origin: bit-equal float math with a materialized
    # rolling-window slice (see costmap.grid_origin); indices stay
    # world-frame via world_to_map's shift.
    ox, oy = grid_origin(cm)
    lo_x, lo_y, hi_x, hi_y = grid_bounds(cm)
    x0, y0, x1, y1 = jnp.broadcast_arrays(
        jnp.asarray(x0, jnp.float32), jnp.asarray(y0, jnp.float32),
        jnp.asarray(x1, jnp.float32), jnp.asarray(y1, jnp.float32))

    big = jnp.float32(jnp.inf)
    mx, my = world_to_map(cm, x0, y0)
    ex, ey = world_to_map(cm, x1, y1)

    dx = x1 - x0
    dy = y1 - y0
    step_x = jnp.where(dx > 0, 1, -1).astype(jnp.int32)
    step_y = jnp.where(dy > 0, 1, -1).astype(jnp.int32)

    # Parametric distance to the next cell boundary along each axis
    # (cpp:117-130 formulas). Cell indices are world-frame; the boundary
    # expression uses window-local indices (mx - lo) against the window
    # origin, the same floats the slice computes.
    edge_x = ox + ((mx - lo_x) + (dx > 0)).astype(jnp.float32) * res
    edge_y = oy + ((my - lo_y) + (dy > 0)).astype(jnp.float32) * res
    t_max_x = jnp.where(dx != 0.0, (edge_x - x0) / dx, big)
    t_max_y = jnp.where(dy != 0.0, (edge_y - y0) / dy, big)
    t_delta_x = jnp.where(dx != 0.0, res / jnp.abs(dx), big)
    t_delta_y = jnp.where(dy != 0.0, res / jnp.abs(dy), big)

    best = cost_at_cell(cm, mx, my)
    # Out-of-bounds endpoint => the segment leaves the map => lethal somewhere
    # along it (see docstring); the start cell is already in `best` via
    # cost_at_cell's OOB policy. Bounds come from grid_bounds so a rolling-
    # window VIEW's out-of-window band counts as off-map here too.
    end_oob = (ex < lo_x) | (ex >= hi_x) | (ey < lo_y) | (ey >= hi_y)
    best = jnp.where(end_oob, jnp.maximum(best, 1.0), best)

    def step(carry, _):
        mx, my, t_max_x, t_max_y, best, done = carry
        done = done | ((mx == ex) & (my == ey))
        take_x = t_max_x < t_max_y  # tie -> y step, like the C++ comparison
        t = jnp.where(take_x, t_max_x, t_max_y)
        nmx = mx + jnp.where(take_x, step_x, 0)
        nmy = my + jnp.where(take_x, 0, step_y)
        nt_max_x = jnp.where(take_x, t_max_x + t_delta_x, t_max_x)
        nt_max_y = jnp.where(take_x, t_max_y, t_max_y + t_delta_y)
        # cpp:146 — a crossing beyond the segment end is not taken.
        past_end = t > 1.0
        advance = ~done & ~past_end
        best = jnp.where(advance, jnp.maximum(best, cost_at_cell(cm, nmx, nmy)),
                         best)
        mx = jnp.where(advance, nmx, mx)
        my = jnp.where(advance, nmy, my)
        t_max_x = jnp.where(advance, nt_max_x, t_max_x)
        t_max_y = jnp.where(advance, nt_max_y, t_max_y)
        done = done | past_end
        return (mx, my, t_max_x, t_max_y, best, done), None

    init = (mx, my, t_max_x, t_max_y, best, jnp.zeros_like(mx, bool))
    (_, _, _, _, best, _), _ = jax.lax.scan(step, init, None, length=h + w)
    return best


def footprint_cost(cm: Costmap, fp: Footprint, samples: int = 32,
                   mode: str = "gather", sample_fn=None) -> jnp.ndarray:
    """Max costmap cost along the polygon boundary (normalized scale, 1.0 =
    collision) — Costmap2d.getFootprintCost equivalent.

    Edges run i -> (i+1) mod n_valid, including the closing edge, matching the
    nav2 footprint checker's edge iteration. Padded vertices are excluded via
    the valid mask.

    mode: "gather"/"onehot" sample each edge at `samples` uniform points
    (choose `samples` via required_edge_samples so the spacing stays below the
    map resolution); "exact" walks every crossed cell (line_cost_exact) and
    ignores `samples`.
    sample_fn: optional (wx, wy) -> costs override for the boundary reads
    (e.g. a per-solve hoisted patch sampler's nearest lookup — identical
    values, contraction over the patch instead of the full map). Ignored in
    "exact" mode, which walks cells through the map directly.
    """
    V = fp.vertices.shape[0]
    idx = jnp.arange(V)
    nxt = jnp.mod(idx + 1, fp.n_valid)
    starts = fp.vertices                      # (V, 2)
    ends = fp.vertices[nxt]                   # (V, 2)
    edge_valid = idx < fp.n_valid             # (V,)

    if mode == "exact":
        costs = line_cost_exact(cm, starts[:, 0], starts[:, 1],
                                ends[:, 0], ends[:, 1])  # (V,)
        return jnp.max(jnp.where(edge_valid, costs, -jnp.inf))

    t = jnp.linspace(0.0, 1.0, samples)       # (S,)
    pts = starts[:, None, :] + (ends - starts)[:, None, :] * t[None, :, None]  # (V, S, 2)
    if sample_fn is not None:
        costs = sample_fn(pts[..., 0], pts[..., 1])  # (V, S)
    else:
        sample = cost_at_world_onehot if mode == "onehot" else cost_at_world
        costs = sample(cm, pts[..., 0], pts[..., 1])  # (V, S)

    costs = jnp.where(edge_valid[:, None], costs, -jnp.inf)
    return jnp.max(costs)


def footprint_cost_at_pose(
    cm: Costmap, fp: Footprint, pose: jnp.ndarray, samples: int = 32,
    mode: str = "gather",
) -> jnp.ndarray:
    """footprintCostAtPose equivalent (NeoMpcPlanner.cpp:218-219): place the
    base-frame footprint at pose and return the boundary max cost (normalized;
    multiply by 255 for the raw nav2 scale used by the plugin's thresholds)."""
    return footprint_cost(cm, transform_footprint(pose, fp), samples, mode)
