"""Device-resident 2-D costmap.

Device-resident replacement for the external `neo_nav2_py_costmap2D.Costmap2d`
(imported at mpc_optimization_server.py:36; used at :246-247, :257, :262, :333,
:343) and the nav2 C++ `Costmap2D` (NeoMpcPlanner.h:144). Costs are normalized
to [0, 1] with 1.0 = lethal, matching the Python server's scale (py:257, :338).

The costmap is a plain pytree of arrays so a whole batch of scenarios can carry
independent obstacle maps (batched leading dims broadcast through every query),
and the map lives in device memory instead of being queried cell-by-cell
over a Python loop.

Conventions chosen for this framework (the external reference lib is not in the
repo; the oracle in `oracle.py` uses the *same* conventions so parity is exact):

- `world_to_map` floors after subtracting the origin (nav2
  Costmap2D::worldToMap: mx = (int)((wx - origin_x) / res) behind a
  wx >= origin_x guard — floor + out-of-bounds-below-origin reproduces both).
- Out-of-bounds queries return lethal cost 1.0 (nav2 returns NO_INFORMATION=255
  for unknown space; normalized that is 1.0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import struct

__all__ = ["Costmap", "CostmapPatch", "u8_source_enabled", "world_to_map",
           "grid_bounds",
           "cost_at_cell",
           "cost_at_world", "cost_at_cells_onehot", "cost_at_world_onehot",
           "cost_at_world_bilinear", "extract_patch", "patch_cost_at_world",
           "extract_window_onehot", "required_patch_halfwidth",
           "extract_patch_onehot", "patch_cost_at_cells",
           "patch_cost_at_world_bilinear", "required_product_patch_halfwidth",
           "ProductPatchSampler"]

LETHAL_COST = 1.0

# Crossover for solver_costmap_u8="auto": below it the convert+divide of the
# u8 source is expected to cost more than its smaller random-read footprint
# saves. The 128² side is a starting point carried over from the engine's
# first backend; it has not been measured on a GPU (PERF.md, open levers).
U8_AUTO_MIN_CELLS = 128 * 128


def u8_source_enabled(solver_costmap_u8, cells: int) -> bool:
    """Resolve the cfg.solver_costmap_u8 knob against a concrete map size.

    `cells` is the number of cells of the GATHER SOURCE the solver actually
    reads (H*W): the world map for zero-copy rolling views, the window for
    materialized rolling slices. "auto"
    turns the uint8 gather source on only for maps of >= 128² cells, where
    the 4x-smaller random-read footprint is expected to start winning
    (U8_AUTO_MIN_CELLS). The exactness caveat is unchanged: decode is u8/255.0
    (bit-identical for nav2 raw-grid maps, <= 1/510 quantization for off-grid
    float maps), so "auto" is an opt-in for grid-sourced deployments, not the
    default.
    """
    if solver_costmap_u8 == "auto":
        return int(cells) >= U8_AUTO_MIN_CELLS
    return bool(solver_costmap_u8)


@struct.dataclass
class Costmap:
    """Normalized costmap grid.

    data:       (H, W) float32 in [0, 1]; row = y cell, col = x cell.
    origin:     (2,) world coordinates of the (0, 0) cell corner.
    resolution: () meters per cell.
    """

    data: jnp.ndarray
    origin: jnp.ndarray
    resolution: jnp.ndarray
    # Optional cached flat view of `data` (..., H*W). Where the (H, W) ->
    # (H*W,) reshape is a real relayout, XLA can re-materialize it at every
    # consumption site inside while/scan bodies (a copy of the whole batched
    # map per trip). Callers
    # that run many queries against a fixed map (batch_step, batch_simulate)
    # hoist it ONCE via with_flat(); None (the default) keeps per-call
    # behavior. Queries are bit-identical either way.
    #
    # CACHE INVARIANT: `flat` is derived state with no auto-invalidation.
    # Anything that replaces `data` on a flattened costmap (e.g. a dynamic
    # obstacle-map update) MUST either pass flat=None in the same replace()
    # or call with_flat() again — a stale flat silently serves old costs.
    flat: "jnp.ndarray | None" = None
    # Optional uint8 companion of `flat` on the nav2 raw 0-255 scale
    # (with_flat(u8=True)). The solver's merit-eval gather is random-read
    # latency/footprint bound; a u8 source is 4x smaller than f32 (16 vs
    # 64 MB of maps at batch 4096, map 64²). Samples decode as u8/255.0 — the SAME
    # expression from_nav2_costmap encodes with, so for any map whose values
    # lie on the raw /255 grid (every map that came from nav2) the decoded
    # cost is BIT-IDENTICAL to the f32 gather, including the ==1.0 lethal
    # branches. Maps with off-grid float values quantize to the nearest
    # /255 step (error <= 1/510) — hence opt-in (cfg.solver_costmap_u8).
    # Same staleness invariant as `flat`.
    flat_u8: "jnp.ndarray | None" = None
    # Optional ZERO-COPY rolling-window view (nav2 rolling local costmap).
    # When win_cells is set, `data`/`flat`/`flat_u8` hold the full WORLD map
    # and the window only narrows the BOUNDS semantics: cells outside the
    # (win_cells,)² rectangle whose lower-corner cell is win_lo read as
    # lethal out-of-bounds, and extent_world() reflects the window size.
    # World→cell math is unchanged (indices stay world-frame), so sampled
    # in-window values are bit-identical to a materialized slice — without
    # the per-tick dynamic_slice copy + re-flatten the slice pays (67 MB of
    # maps per tick at batch 4096×64²). Build via simulation.rolling_view.
    win_lo: "jnp.ndarray | None" = None     # (..., 2) int32 (col, row)
    win_cells: "int | None" = struct.field(pytree_node=False,
                                                default=None)

    def with_flat(self, u8: bool = False) -> "Costmap":
        """Cache the flattened data view (amortizes the relayout copy).

        u8=True additionally caches the raw-scale uint8 companion used by the
        solver's hot-loop gather (see flat_u8)."""
        h, w = self.data.shape[-2], self.data.shape[-1]
        flat = self.data.reshape(self.data.shape[:-2] + (h * w,))
        flat_u8 = None
        if u8:
            flat_u8 = jnp.round(flat * 255.0).clip(0.0, 255.0).astype(
                jnp.uint8)
        return self.replace(flat=flat, flat_u8=flat_u8)

    def update_window(self, cells: jnp.ndarray, lo) -> "Costmap":
        """Incremental update: write a (h, w) block of normalized costs whose
        lower cell corner is lo = (col, row), returning the updated costmap.

        This is the missing deployment piece the reference gets for free from
        its ROS ecosystem — the live local costmap behind every solve
        (mpc_optimization_server.py:118 subscribes the costmap topics;
        NeoMpcPlanner.h:142-144 holds a rolling costmap_ros_). Re-staging
        the whole grid per tick moves 64 KB for a 128² f32 grid against
        ~1-4 KB for a dirty window, pays a fresh flatten and breaks
        cross-tick fusion.

        Cache invariant (see `flat`): the cached flat/u8 views are REFRESHED
        from the same write (an elementwise blend over the hoisted views, no
        re-layout through with_flat), so downstream samplers keep reading
        them with no staleness and no re-flatten.
        Rolling-window views update the WORLD map (indices are world-frame
        cell coordinates, like nav2's updateMap); move the window itself by
        replacing win_lo. Unbatched (H, W) maps here; batch via vmap, where
        per-lane `lo` vectors update each lane's own map.
        """
        cells = jnp.asarray(cells, self.data.dtype)
        # Sanitize non-finite input BEFORE the one-hot contraction: a single
        # Inf/NaN cell would turn 0·inf terms into NaN across the whole
        # canvas row/column (unlike the localized dynamic_update_slice this
        # replaced). Policy matches the serving wire boundary: NaN / +Inf
        # are unknown/overflow sensor readings → lethal (1.0); -Inf → 0.
        cells = jnp.nan_to_num(cells, nan=1.0, posinf=1.0, neginf=0.0)
        lo = jnp.asarray(lo, jnp.int32)
        # Clamp the corner ONCE so the (H, W) write and the flat-view writes
        # agree exactly (the same clamped corner feeds both).
        hh, ww = self.data.shape[-2], self.data.shape[-1]
        hc, wc = cells.shape[-2], cells.shape[-1]
        if hc > hh or wc > ww:
            # The dynamic_update_slice formulation rejected this at trace
            # time (slice sizes must fit the operand); the one-hot blend
            # would silently write zeros instead — keep it an error.
            raise ValueError(
                f"update block {(hc, wc)} exceeds the map {(hh, ww)}")
        col = jnp.clip(lo[..., 0], 0, ww - wc)
        row = jnp.clip(lo[..., 1], 0, hh - hc)
        # SCATTER-FREE write. The natural dynamic_update_slice becomes a
        # scatter under vmap (per-lane offsets), which the engine's first
        # backend ran lane by lane. Instead build a full-size canvas
        # holding the patch at its offset via the ADJOINT of
        # extract_window_onehot (same one-hot factors, transposed
        # contraction; Precision.HIGHEST keeps picked values bit-exact) —
        # then blend with elementwise `where`. Matrix-unit + bandwidth work,
        # no scatter anywhere, and the flat/u8 views refresh from the same
        # canvas (reshape, not re-layout logic). Whether a GPU's scatter
        # beats this is not measured yet (ROADMAP, writes to the live map).
        ri = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 0)
        ci = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 1)
        inw = ((ri >= row) & (ri < row + hc)
               & (ci >= col) & (ci < col + wc))
        rows1h, cols1h = _window_onehots(row, col, hc, wc, hh, ww,
                                         self.data.dtype)
        patch = jnp.dot(
            rows1h.T,
            jnp.dot(cells, cols1h, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32).astype(self.data.dtype)
        data = jnp.where(inw, patch, self.data)
        flat = self.flat
        flat_u8 = self.flat_u8
        if flat is not None:
            flat = jnp.where(inw.reshape(-1), patch.reshape(-1), flat)
        if flat_u8 is not None:
            enc = (jnp.round(patch * 255.0).clip(0.0, 255.0)
                   .astype(jnp.uint8))
            flat_u8 = jnp.where(inw.reshape(-1), enc.reshape(-1), flat_u8)
        return self.replace(data=data, flat=flat, flat_u8=flat_u8)

    @staticmethod
    def create(data, origin=(0.0, 0.0), resolution=0.05) -> "Costmap":
        # Guard concrete (host-side) resolutions: zero/negative would turn
        # every world_to_map into garbage indices (nav2 asserts the same
        # invariant at map creation). Traced/array resolutions (batched maps
        # built under vmap) pass through — the host constructors are the
        # validation boundary.
        if isinstance(resolution, (int, float)) and resolution <= 0:
            raise ValueError(f"resolution must be positive: {resolution}")
        return Costmap(
            data=jnp.asarray(data, jnp.float32),
            origin=jnp.asarray(origin, jnp.float32),
            resolution=jnp.asarray(resolution, jnp.float32),
        )

    @staticmethod
    def from_nav2_costmap(raw, origin=(0.0, 0.0), resolution=0.05,
                          inscribed_is_lethal: bool = False) -> "Costmap":
        """From the raw nav2 Costmap2D 0-255 scale (the C++ plugin's world,
        NeoMpcPlanner.cpp:218/234).

        Every raw value scales by 1/255, so only raw 255 (LETHAL_OBSTACLE /
        NO_INFORMATION) lands exactly on 1.0. This preserves the reference's
        raw-scale gate semantics: the plugin throws only at footprint cost
        == 255 (cpp:234) and slow-downs at > 200 (cpp:225/228); raw 254
        (INSCRIBED_INFLATED) maps to 254/255 ≈ 0.996, which still trips the
        predicted-collision check (>= 0.99, py:338) but NOT the exact-equality
        lethal branches (py:257, :262; the 1.0 gates here).

        inscribed_is_lethal=True folds 254 into 1.0 as well — the conservative
        divergence round 1 shipped by default (a robot whose center must never
        enter the inscribed band); off by default for reference parity.
        """
        raw = jnp.asarray(raw)
        norm = raw.astype(jnp.float32) / 255.0
        if inscribed_is_lethal:
            norm = jnp.where(raw >= 254, 1.0, norm)
        return Costmap.create(norm, origin, resolution)

    @staticmethod
    def from_occupancy_grid(grid, origin=(0.0, 0.0), resolution=0.05,
                            unknown_is_lethal=True) -> "Costmap":
        """From a nav_msgs/OccupancyGrid payload (int8: 0..100 occupancy,
        -1 unknown). 100 -> 1.0 lethal; unknown -> lethal by default (the
        conservative nav2 convention for unknown space)."""
        g = jnp.asarray(grid)
        norm = jnp.clip(g.astype(jnp.float32) / 100.0, 0.0, 1.0)
        if unknown_is_lethal:
            norm = jnp.where(g < 0, 1.0, norm)
        else:
            norm = jnp.where(g < 0, 0.0, norm)
        return Costmap.create(norm, origin, resolution)

    @property
    def shape(self):
        return self.data.shape

    def extent_world(self):
        """Half extent used by plan pruning (NeoMpcPlanner.cpp:80-82):
        max(size_cells_x, size_cells_y) * resolution / 2. For a rolling
        view, the WINDOW size — the extent the controller sees."""
        if self.win_cells is not None:
            return self.win_cells * self.resolution / 2.0
        h, w = self.data.shape[-2], self.data.shape[-1]
        return jnp.maximum(h, w) * self.resolution / 2.0


def grid_bounds(cm: Costmap):
    """The in-bounds cell rectangle [lo_x, hi_x) × [lo_y, hi_y) in world-frame
    cell coordinates: the full grid, or the rolling-window rectangle when the
    zero-copy view is set. Every sampler's OOB policy routes through this so
    the window semantics live in one place."""
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    if cm.win_cells is None:
        return 0, 0, w, h
    lo_x = cm.win_lo[..., 0]
    lo_y = cm.win_lo[..., 1]
    return lo_x, lo_y, lo_x + cm.win_cells, lo_y + cm.win_cells


def grid_origin(cm: Costmap):
    """Effective (ox, oy) grid origin for index math: the window's origin for
    a rolling view — computed with the SAME float expression a materialized
    slice would carry (origin + lo_cell·resolution), so floor-boundary
    rounding is bit-identical between the view and the slice."""
    ox = cm.origin[..., 0]
    oy = cm.origin[..., 1]
    if cm.win_cells is not None:
        ox = ox + cm.win_lo[..., 0].astype(jnp.float32) * cm.resolution
        oy = oy + cm.win_lo[..., 1].astype(jnp.float32) * cm.resolution
    return ox, oy


def world_to_map(cm: Costmap, wx: jnp.ndarray, wy: jnp.ndarray):
    """World → integer cell indices, flooring.

    Mirrors nav2 Costmap2D::worldToMap (used via Costmap2d.getWorldToMap at
    mpc_optimization_server.py:246): coordinates below the origin fail the
    wx < origin_x guard there, i.e. are out of bounds. Floor reproduces that —
    the band (origin − resolution, origin) maps to index −1 (OOB → lethal),
    where truncation toward zero would alias it onto cell 0 (an ADVICE round-1
    finding). At/above the origin floor and truncation agree.

    Returns raw (possibly out-of-range) WORLD-frame indices; bounds handling
    happens in cost_at_cell so the out-of-bounds policy lives in one place.
    For a rolling view the float math runs against the WINDOW origin (the
    expression a materialized slice would use — grid_origin) and shifts back
    by the window corner, so boundary rounding matches the slice bit-for-bit.
    """
    ox, oy = grid_origin(cm)
    mx = jnp.int32(jnp.floor((wx - ox) / cm.resolution))
    my = jnp.int32(jnp.floor((wy - oy) / cm.resolution))
    if cm.win_cells is not None:
        mx = mx + cm.win_lo[..., 0]
        my = my + cm.win_lo[..., 1]
    return mx, my


def cost_at_cell(cm: Costmap, mx: jnp.ndarray, my: jnp.ndarray) -> jnp.ndarray:
    """Cell cost with lethal out-of-bounds (Costmap2d.getCost equivalent,
    mpc_optimization_server.py:247).

    The lookup is a flattened 1-D gather (row * W + col) rather than 2-D
    advanced indexing (the 2-D form compiled pathologically slowly on the
    engine's first backend). Batched costmaps are handled by vmap, so data
    is (H, W) here.
    """
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    lo_x, lo_y, hi_x, hi_y = grid_bounds(cm)
    in_bounds = (mx >= lo_x) & (mx < hi_x) & (my >= lo_y) & (my < hi_y)
    mxc = jnp.clip(mx, 0, w - 1)
    myc = jnp.clip(my, 0, h - 1)
    flat = (cm.flat if cm.flat is not None
            else cm.data.reshape(cm.data.shape[:-2] + (h * w,)))
    val = flat[..., myc * w + mxc]
    return jnp.where(in_bounds, val, LETHAL_COST)


def cost_at_world(cm: Costmap, wx: jnp.ndarray, wy: jnp.ndarray) -> jnp.ndarray:
    """Nearest-cell world-coordinate lookup — the reference's sampling mode
    (getWorldToMap + getCost, mpc_optimization_server.py:246-247)."""
    mx, my = world_to_map(cm, wx, wy)
    return cost_at_cell(cm, mx, my)


def cost_at_cells_onehot(cm: Costmap, mx: jnp.ndarray, my: jnp.ndarray) -> jnp.ndarray:
    """Nearest-cell sampling via one-hot contractions — the matrix-unit
    alternative to gathers for *many* samples per map.

    For S sample points the lookup data[my, mx] is computed as

        T = R @ data        with R[s, h] = (my[s] == h)     -> (S, W)
        c[s] = Σ_w T[s, w] * C[s, w]   with C[s, w] = (mx[s] == w)

    Both contractions run on dense 0/1 operands and fuse with the
    surrounding arithmetic; on a backend without a fast vector gather this
    beats the gather at hundreds of samples (on a GPU it is one of the
    levers still to A/B, PERF.md). Exact: each output picks exactly one
    cell.
    mx/my: (S,) int32 flattened sample indices. Out-of-bounds -> LETHAL_COST.
    """
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    lo_x, lo_y, hi_x, hi_y = grid_bounds(cm)
    in_bounds = (mx >= lo_x) & (mx < hi_x) & (my >= lo_y) & (my < hi_y)
    mxc = jnp.clip(mx, 0, w - 1)
    myc = jnp.clip(my, 0, h - 1)
    rows = (myc[:, None] == jnp.arange(h)[None, :]).astype(cm.data.dtype)  # (S, H)
    cols = (mxc[:, None] == jnp.arange(w)[None, :]).astype(cm.data.dtype)  # (S, W)
    # HIGHEST: a default-precision float32 product may run in a reduced
    # format (TF32 on a GPU) that rounds the picked values; at HIGHEST the
    # 0/1 factors pick every value exactly, keeping the "picks exactly one
    # cell" contract bit-true on device, not just on CPU.
    t = jnp.dot(rows, cm.data, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)                         # (S, W)
    vals = jnp.sum(t * cols, axis=-1)
    return jnp.where(in_bounds, vals, LETHAL_COST)


def cost_at_world_onehot(cm: Costmap, wx: jnp.ndarray, wy: jnp.ndarray) -> jnp.ndarray:
    """World-coordinate one-hot sampling; accepts any sample shape (flattened
    internally). Semantics identical to cost_at_world."""
    shape = wx.shape
    mx, my = world_to_map(cm, wx.reshape(-1), wy.reshape(-1))
    return cost_at_cells_onehot(cm, mx, my).reshape(shape)


@struct.dataclass
class CostmapPatch:
    """A small window of a costmap centered on the robot, extracted ONCE per
    solve so the solver's hot loop never touches the full map.

    Why: each merit/objective evaluation samples the costmap at only
    control_steps points per scenario, but expressing that on the full map
    costs either a latency-bound 12k-element gather or a 67 MB one-hot sweep
    per evaluation — and XLA re-materializes the flattened-map layout copy
    inside the line-search `while` (134 MB per trip at batch 4096). The
    patch turns every in-loop sample into a ~1 KB-per-lane one-hot contract.

    Correctness: the window half-width is chosen from the velocity box bounds
    (required_patch_halfwidth), so every rollout position the solver can ever
    evaluate lands inside the window; cells outside the window are provably
    off-map (see extract_patch) and read as lethal, matching cost_at_world's
    out-of-bounds policy. Index math reuses world_to_map, so values are
    bit-identical to the full-map path.

    data:  (P, P) window, P = 2*halfwidth + 1, off-map cells = 1.0.
    cell0: (2,) int32 — full-map (col, row) cell coordinates of data[0, 0]
           (may be negative near the map edge).
    """

    data: jnp.ndarray
    cell0: jnp.ndarray


def _window_onehots(row, col, hc: int, wc: int, hh: int, ww: int, dtype):
    """The (hc, H)/(wc, W) one-hot factors shared by the window WRITE
    (update_window's patch canvas) and the window READ
    (extract_window_onehot) — one construction so the two paths cannot
    silently diverge in dtype/precision handling."""
    rows1h = (row + jnp.arange(hc)[:, None]
              == jnp.arange(hh)[None, :]).astype(dtype)        # (hc, H)
    cols1h = (col + jnp.arange(wc)[:, None]
              == jnp.arange(ww)[None, :]).astype(dtype)        # (wc, W)
    return rows1h, cols1h


def extract_window_onehot(data: jnp.ndarray, row, col,
                          hc: int, wc: int) -> jnp.ndarray:
    """(hc, wc) window of `data` whose corner is (row, col) — the
    gather-free form of lax.dynamic_slice for BATCHED use: under vmap a
    dynamic_slice with per-lane offsets lowers to a gather, which at fleet
    batch sizes is latency-bound on a backend without a fast vector gather.
    Two one-hot contractions instead run on the matrix unit;
    Precision.HIGHEST keeps every picked value bit-exact. (row, col) are canonicalized in-range
    internally with lax.dynamic_slice's exact semantics — negative indices
    wrap from the end, then clamp to [0, dim − size] — so this is a drop-in
    for the slice it replaces (an out-of-range one-hot would otherwise
    silently read zeros). Unbatched (H, W) here; batch via vmap."""
    hh, ww = data.shape[-2], data.shape[-1]
    row = jnp.asarray(row, jnp.int32)
    col = jnp.asarray(col, jnp.int32)
    row = jnp.clip(jnp.where(row < 0, row + hh, row), 0, hh - hc)
    col = jnp.clip(jnp.where(col < 0, col + ww, col), 0, ww - wc)
    r1h, c1h = _window_onehots(row, col, hc, wc, hh, ww, data.dtype)
    t = jnp.dot(r1h, data, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)            # (hc, W)
    return jnp.dot(t, c1h.T, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32).astype(data.dtype)


def required_patch_halfwidth(cfg, resolution: float) -> int:
    """Cells the rollout can traverse from the start cell: the box-bound
    translational speed sqrt(max|vx|² + max|vy|²) times the horizon, in cells,
    plus one for the floor-boundary crossing."""
    import math

    vx = max(abs(cfg.min_vel_x), abs(cfg.max_vel_x))
    vy = max(abs(cfg.min_vel_y), abs(cfg.max_vel_y))
    v = math.sqrt(vx * vx + vy * vy)
    return int(math.ceil(v * cfg.prediction_horizon / float(resolution))) + 1


def extract_patch(cm: Costmap, cx: jnp.ndarray, cy: jnp.ndarray,
                  halfwidth: int) -> CostmapPatch:
    """Extract the (2h+1)² window around world point (cx, cy).

    The map is padded with a lethal ring of width h, and the slice start is
    clamped into the padded array. Consequences (each provably safe):
    - robot cell inside the map → the window is exactly cells
      [c−h, c+h]² with off-map cells lethal;
    - robot cell outside the map → the clamped window still carries correct
      values for every cell it covers, and any sampled cell it does NOT cover
      is off-map (start clamps only when the center cell is off-map, and then
      only cells beyond the map edge fall outside the window) → the
      out-of-window lethal fallback in patch_cost_at_world is exact.
    """
    h = halfwidth
    H, W = cm.data.shape[-2], cm.data.shape[-1]
    P = 2 * h + 1
    mx0, my0 = world_to_map(cm, cx, cy)
    padded = jnp.pad(cm.data, ((h, h), (h, h)), constant_values=LETHAL_COST)
    sx = jnp.clip(mx0, 0, W - 1)
    sy = jnp.clip(my0, 0, H - 1)
    data = jax.lax.dynamic_slice(padded, (sy, sx), (P, P))
    return CostmapPatch(data=data, cell0=jnp.stack([sx - h, sy - h]))


def patch_cost_at_world(cm: Costmap, patch: CostmapPatch, wx: jnp.ndarray,
                        wy: jnp.ndarray) -> jnp.ndarray:
    """Nearest-cell lookup through the patch — bit-identical to
    cost_at_world(cm, wx, wy) for every point within the patch's coverage
    guarantee (world_to_map does the index math; the patch only re-homes the
    read). Sampling is a rows/cols one-hot contraction (P ≈ 33), which stays
    in the solver's fused loop instead of a latency-bound HBM gather.
    wx/wy: (S,) sample points."""
    mx, my = world_to_map(cm, wx, wy)
    return patch_cost_at_cells(patch, mx, my)


def extract_patch_onehot(cm: Costmap, cx: jnp.ndarray, cy: jnp.ndarray,
                         halfwidth: int) -> CostmapPatch:
    """extract_patch without the padded-map dynamic_slice: under vmap the
    per-lane slice lowers to a latency-bound batched gather (the same
    pathology extract_window_onehot exists for) and the (H+2h)² padded copy
    costs real HBM traffic per lane. Here the (P, P) window is two one-hot
    contractions straight off `data`, with the corner UNCLAMPED: rows/cols
    outside the map produce all-zero one-hot rows, and those cells are
    rewritten to LETHAL by an explicit validity mask — so the patch holds
    exactly the map values inside the grid and LETHAL outside, for ANY
    center (coverage is exact even when the center cell is off-map, which
    the clamped extract_patch only guarantees via its off-map argument).
    Precision.HIGHEST keeps picked values bit-exact (0/1 factors)."""
    h = halfwidth
    H, W = cm.data.shape[-2], cm.data.shape[-1]
    P = 2 * h + 1
    mx0, my0 = world_to_map(cm, cx, cy)
    c0x = mx0 - h
    c0y = my0 - h
    ri = c0y + jnp.arange(P)                                  # (P,) rows
    ci = c0x + jnp.arange(P)                                  # (P,) cols
    rows1h = (ri[:, None] == jnp.arange(H)[None, :]).astype(cm.data.dtype)
    cols1h = (ci[:, None] == jnp.arange(W)[None, :]).astype(cm.data.dtype)
    t = jnp.dot(rows1h, cm.data, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)           # (P, W)
    picked = jnp.dot(t, cols1h.T, precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)      # (P, P)
    valid = ((ri >= 0) & (ri < H))[:, None] & ((ci >= 0) & (ci < W))[None, :]
    data = jnp.where(valid, picked.astype(cm.data.dtype), LETHAL_COST)
    return CostmapPatch(data=data, cell0=jnp.stack([c0x, c0y]))


def patch_cost_at_cells(patch: CostmapPatch, mx: jnp.ndarray,
                        my: jnp.ndarray, exact: bool = True) -> jnp.ndarray:
    """Nearest-cell read by FULL-MAP cell indices through a patch — the
    cell-indexed companion of patch_cost_at_world (same one-hot contraction,
    same out-of-patch -> LETHAL policy; exact for every cell inside the
    patch's coverage guarantee, where off-map cells carry the lethal ring).

    exact=True (default): Precision.HIGHEST picks — bit-identical to the
    full-map samplers on every backend. exact=False: the backend's default
    matmul precision — TF32 on an NVIDIA GPU, i.e. picked values round to
    10 mantissa bits (≤2^-11 relative on [0, 1] costs; CPU stays exact
    either way). The fast path is for the smooth PRODUCT objective, which
    has no exact-equality semantics downstream; chip_smoke.py prints its
    goal capture on the card. config.solver_patch_exact_picks plumbs the
    choice."""
    P = patch.data.shape[-1]
    ix = mx - patch.cell0[..., 0]
    iy = my - patch.cell0[..., 1]
    inb = (ix >= 0) & (ix < P) & (iy >= 0) & (iy < P)
    ixc = jnp.clip(ix, 0, P - 1)
    iyc = jnp.clip(iy, 0, P - 1)
    rows = (iyc[..., :, None] == jnp.arange(P)[None, :]).astype(
        patch.data.dtype)
    cols = (ixc[..., :, None] == jnp.arange(P)[None, :]).astype(
        patch.data.dtype)
    t = jnp.einsum("...sp,...pq->...sq", rows, patch.data,
                   precision=(jax.lax.Precision.HIGHEST if exact
                              else jax.lax.Precision.DEFAULT))
    vals = jnp.sum(t * cols, axis=-1)
    return jnp.where(inb, vals, LETHAL_COST)


def patch_cost_at_world_bilinear(cm: Costmap, patch: CostmapPatch,
                                 wx: jnp.ndarray, wy: jnp.ndarray,
                                 exact: bool = True) -> jnp.ndarray:
    """cost_at_world_bilinear through a patch: identical index/weight math;
    the four neighbor reads become ONE fused 4S-point one-hot contraction on
    the (P, P) window instead of four full-map reads. Values match the
    full-map sampler bit-for-bit inside the coverage guarantee (the +1
    bilinear neighbor must be inside the patch — include it in the
    halfwidth; see required_product_patch_halfwidth)."""
    x0i, y0i, tx, ty = _bilinear_setup(cm, wx, wy)
    shape = x0i.shape                       # (S,) sample points (vmap batches)
    x0f = x0i.reshape(-1)
    y0f = y0i.reshape(-1)
    mx = jnp.stack([x0f, x0f + 1, x0f, x0f + 1], axis=-1).reshape(-1)  # (4S,)
    my = jnp.stack([y0f, y0f, y0f + 1, y0f + 1], axis=-1).reshape(-1)
    c = patch_cost_at_cells(patch, mx, my, exact=exact).reshape(shape + (4,))
    c00, c10, c01, c11 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def required_product_patch_halfwidth(cfg, resolution: float,
                                     footprint_radius_m: float) -> int:
    """Patch halfwidth for the PRODUCT objective's hoisted sampler: the
    rollout reach (required_patch_halfwidth) plus the footprint boundary's
    circumradius in cells (every edge sample lies within it of a rollout
    pose) plus one cell for the bilinear +1 neighbor. A too-small radius is
    conservative, not unsafe: out-of-patch reads are LETHAL, so the solver
    sees phantom obstacles near the rim instead of free space."""
    import math

    return (required_patch_halfwidth(cfg, resolution)
            + int(math.ceil(footprint_radius_m / float(resolution))) + 1)


class ProductPatchSampler:
    """Per-solve hoisted sampler for the smooth product objective: one patch
    extraction (one-hot contractions, no gather) feeds every bilinear point cost and
    every footprint boundary sample of the solve, so the solver's line-search
    loop contracts over (P, P) ≈ 10³ cells instead of the full map
    (64² = 4.1k, 128² = 16.4k) — the product twin of make_point_sampler.

    exact: pick precision for the in-loop contractions (see
    patch_cost_at_cells) — True is bit-identical to the full-map samplers
    on every backend; False takes the backend's fast matmul path (TF32
    picks on a GPU; the product_config preset ships False via
    config.solver_patch_exact_picks).
    The per-solve patch EXTRACTION is Precision.HIGHEST either way."""

    def __init__(self, cm: Costmap, cx, cy, halfwidth: int,
                 exact: bool = True):
        if cm.win_cells is not None:
            raise ValueError(
                "product patch sampling is not supported on a rolling-window "
                "VIEW costmap (out-of-window cells would read as map values); "
                "leave solver_costmap_patch=0 for views")
        self.cm = cm
        self.exact = exact
        self.patch = extract_patch_onehot(cm, cx, cy, halfwidth)

    def bilinear(self, wx, wy):
        return patch_cost_at_world_bilinear(self.cm, self.patch, wx, wy,
                                            exact=self.exact)

    def nearest(self, wx, wy):
        shape = wx.shape
        mx, my = world_to_map(self.cm, wx.reshape(-1), wy.reshape(-1))
        return patch_cost_at_cells(self.patch, mx, my,
                                   exact=self.exact).reshape(shape)


def make_point_sampler(cm: Costmap, cx, cy, patch_halfwidth: int):
    """Build the solver-loop point sampler, hoisting per-solve work out of the
    iteration loop.

    patch_halfwidth > 0: extract a CostmapPatch around (cx, cy) once and
    sample it with one-hot contractions (fastest; requires the half-width
    physics bound, see required_patch_halfwidth).

    patch_halfwidth == 0: pre-flatten the map once and gather. XLA does NOT
    always hoist the (H, W) -> (H*W,) relayout out of `while` loops (a
    134 MB copy per line-search trip at batch 4096), so materializing the
    flat buffer here, before the loop, removes that copy while keeping the
    exact gather semantics of cost_at_world.
    """
    if patch_halfwidth > 0:
        if cm.win_cells is not None:
            raise ValueError(
                "solver_costmap_patch is not supported on a rolling-window "
                "VIEW costmap (the patch would read world cells outside the "
                "window without the lethal out-of-window policy); use the "
                "materializing rolling_window slice instead")
        # One-hot contraction on the window (a flat-gather variant of this
        # path lost to it on the engine's first backend; not re-measured
        # on a GPU).
        patch = extract_patch(cm, cx, cy, patch_halfwidth)

        def sample(wx, wy):
            return patch_cost_at_world(cm, patch, wx, wy)

        return sample

    h, w = cm.data.shape[-2], cm.data.shape[-1]
    flat = (cm.flat if cm.flat is not None
            else cm.data.reshape(cm.data.shape[:-2] + (h * w,)))
    # Prefer the 4x-smaller u8 source when the caller cached one
    # (with_flat(u8=True)); decode u8/255.0 matches from_nav2_costmap's
    # encode expression bit-for-bit for raw-grid maps (see Costmap.flat_u8).
    flat_q = cm.flat_u8
    lo_x, lo_y, hi_x, hi_y = grid_bounds(cm)

    def sample(wx, wy):
        mx, my = world_to_map(cm, wx, wy)
        in_bounds = (mx >= lo_x) & (mx < hi_x) & (my >= lo_y) & (my < hi_y)
        mxc = jnp.clip(mx, 0, w - 1)
        myc = jnp.clip(my, 0, h - 1)
        if flat_q is not None:
            val = flat_q[..., myc * w + mxc].astype(jnp.float32) / 255.0
        else:
            val = flat[..., myc * w + mxc]
        return jnp.where(in_bounds, val, LETHAL_COST)

    return sample


def _bilinear_setup(cm: Costmap, wx: jnp.ndarray, wy: jnp.ndarray):
    """Shared bilinear index/weight derivation: world point -> the world-frame
    cell index of the lower-left neighbor plus fractional weights (cell-center
    sampling). Single source of truth for the full-map and patch-backed
    bilinear samplers — the two must stay bit-identical in their index math
    for the patch equivalence guarantee to hold."""
    ox, oy = grid_origin(cm)
    fx = (wx - ox) / cm.resolution - 0.5
    fy = (wy - oy) / cm.resolution - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = jnp.int32(x0)
    y0i = jnp.int32(y0)
    if cm.win_cells is not None:  # window-local -> world-frame cell indices
        x0i = x0i + cm.win_lo[..., 0]
        y0i = y0i + cm.win_lo[..., 1]
    return x0i, y0i, tx, ty


def cost_at_world_bilinear(cm: Costmap, wx: jnp.ndarray, wy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear world-coordinate sampling (product mode; BASELINE.json config 3).

    Smooth in (wx, wy) so jax.grad of the costmap term gives a useful descent
    direction instead of the zero-almost-everywhere gradient of nearest-cell
    sampling. Samples at cell centers.
    """
    x0i, y0i, tx, ty = _bilinear_setup(cm, wx, wy)

    c00 = cost_at_cell(cm, x0i, y0i)
    c10 = cost_at_cell(cm, x0i + 1, y0i)
    c01 = cost_at_cell(cm, x0i, y0i + 1)
    c11 = cost_at_cell(cm, x0i + 1, y0i + 1)
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty
