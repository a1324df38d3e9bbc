"""Unit tests for the kernel-level ops: SE(2), rollout, costmap, footprint.

Strategy per SURVEY.md §4: each device op is checked against a closed form or
an independent numpy computation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops import se2
from neo_mpc_planner2_tpu.oracle import NpCostmap, _rollout_np


class TestSe2:
    def test_yaw_quat_roundtrip(self):
        yaws = jnp.linspace(-3.0, 3.0, 13)
        q = se2.quat_from_yaw(yaws)
        back = se2.yaw_from_quat(q)
        np.testing.assert_allclose(back, yaws, atol=1e-6)

    def test_compose_inverse(self):
        a = jnp.array([1.0, 2.0, 0.7])
        ident = se2.se2_compose(a, se2.se2_inverse(a))
        np.testing.assert_allclose(ident, jnp.zeros(3), atol=1e-6)

    def test_world_body_roundtrip(self):
        robot = jnp.array([2.0, -1.0, 1.2])
        p = jnp.array([3.0, 0.5, -0.4])
        body = se2.world_to_body(robot, p)
        back = se2.body_to_world(robot, body)
        np.testing.assert_allclose(back, p, atol=1e-6)

    def test_wrap_angle(self):
        np.testing.assert_allclose(se2.wrap_angle(jnp.float32(jnp.pi + 0.1)),
                                   -jnp.pi + 0.1, atol=1e-6)


class TestRollout:
    def test_matches_numpy_integrator(self):
        cmd = np.array([[0.3, -0.1, 0.4], [0.2, 0.2, -0.3], [-0.1, 0.0, 0.1]])
        init = np.array([1.0, -0.5, 0.3])
        expected = _rollout_np(cmd, 0.8 / 3, init)
        got = mpc.rollout(jnp.asarray(cmd, jnp.float32), jnp.float32(0.8 / 3),
                          jnp.asarray(init, jnp.float32))
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)

    def test_pure_rotation_keeps_position(self):
        cmd = jnp.array([[0.0, 0.0, 0.5]] * 3)
        traj = mpc.rollout(cmd, jnp.float32(0.1), jnp.zeros(3))
        np.testing.assert_allclose(traj[:, :2], 0.0, atol=1e-7)
        np.testing.assert_allclose(traj[:, 2], [0.05, 0.10, 0.15], atol=1e-6)

    def test_straight_line_closed_form(self):
        # No rotation: x advances vx*dt per step.
        cmd = jnp.array([[0.4, 0.0, 0.0]] * 3)
        traj = mpc.rollout(cmd, jnp.float32(0.25), jnp.zeros(3))
        np.testing.assert_allclose(traj[:, 0], [0.1, 0.2, 0.3], atol=1e-6)

    def test_grad_flows(self):
        def loss(cmd):
            return jnp.sum(mpc.rollout(cmd, jnp.float32(0.1), jnp.zeros(3)) ** 2)

        g = jax.grad(loss)(jnp.ones((3, 3)))
        assert np.all(np.isfinite(g))


class TestCostmap:
    def test_lookup_matches_oracle(self):
        rng = np.random.default_rng(0)
        data = rng.uniform(0, 1, (30, 20))
        cm = mpc.Costmap.create(data, origin=(-0.3, -0.7), resolution=0.05)
        npcm = NpCostmap(data, np.array([-0.3, -0.7]), 0.05)
        pts = rng.uniform(-1.2, 1.2, (200, 2))
        got = mpc.cost_at_world(cm, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
        want = [npcm.get_cost_world(x, y) for x, y in pts]
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_out_of_bounds_is_lethal(self):
        cm = mpc.Costmap.create(np.zeros((10, 10)), origin=(0.0, 0.0), resolution=0.1)
        assert float(mpc.cost_at_world(cm, jnp.float32(-0.5), jnp.float32(0.5))) == 1.0
        assert float(mpc.cost_at_world(cm, jnp.float32(5.0), jnp.float32(0.5))) == 1.0

    def test_below_origin_band_is_lethal(self):
        """nav2 worldToMap returns false for wx < origin_x; flooring makes the
        one-cell band just below the origin OOB (lethal) instead of aliasing
        onto cell 0 (an ADVICE round-1 finding — truncation toward zero)."""
        cm = mpc.Costmap.create(np.zeros((10, 10)), origin=(0.0, 0.0), resolution=0.1)
        npcm = NpCostmap(np.zeros((10, 10)), np.zeros(2), 0.1)
        for x, y, want in [(-0.05, 0.5, 1.0), (0.5, -0.001, 1.0),
                           (0.0, 0.5, 0.0), (0.05, 0.05, 0.0)]:
            assert float(mpc.cost_at_world(cm, jnp.float32(x), jnp.float32(y))) == want
            assert npcm.get_cost_world(x, y) == want
        # One-hot sampling path agrees.
        from neo_mpc_planner2_tpu.ops.costmap import cost_at_world_onehot
        v = cost_at_world_onehot(cm, jnp.asarray([-0.05, 0.05]),
                                 jnp.asarray([0.5, 0.05]))
        np.testing.assert_allclose(np.asarray(v), [1.0, 0.0])

    def test_bilinear_interpolates(self):
        data = np.zeros((4, 4))
        data[1, 1] = 1.0
        cm = mpc.Costmap.create(data, origin=(0.0, 0.0), resolution=1.0)
        # Cell centers at (1.5, 1.5); halfway toward (2.5, 1.5) should be 0.5.
        v = float(mpc.cost_at_world_bilinear(cm, jnp.float32(2.0), jnp.float32(1.5)))
        assert abs(v - 0.5) < 1e-6

    def test_bilinear_grad_nonzero(self):
        data = np.zeros((8, 8))
        data[4, 4] = 1.0
        cm = mpc.Costmap.create(data, origin=(0.0, 0.0), resolution=0.5)
        g = jax.grad(lambda x: mpc.cost_at_world_bilinear(cm, x, jnp.float32(2.25)))(
            jnp.float32(2.0)
        )
        assert abs(float(g)) > 0.0


class TestFootprint:
    def test_rect_vertices(self):
        fp = mpc.Footprint.rectangle(0.6, 0.4)
        assert int(fp.n_valid) == 4
        np.testing.assert_allclose(fp.vertices[0], [0.3, 0.2])

    def test_clear_map_cost_zero(self, empty_costmap, footprint):
        c = mpc.footprint_cost(empty_costmap, footprint, samples=8)
        assert float(c) == 0.0

    def test_detects_obstacle_on_edge(self):
        data = np.zeros((40, 40))
        data[20, 26] = 1.0  # world ~ (0.325, 0.025) with origin (-1,-1) res 0.05
        cm = mpc.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05)
        fp = mpc.Footprint.rectangle(0.7, 0.1)
        # Edge passes through the lethal cell.
        c = mpc.footprint_cost(cm, fp, samples=64)
        assert float(c) == 1.0

    def test_matches_oracle_sampling(self):
        rng = np.random.default_rng(1)
        data = rng.uniform(0, 0.9, (40, 40))
        cm = mpc.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05)
        npcm = NpCostmap(data, np.array([-1.0, -1.0]), 0.05)
        # Off-grid vertices: on exact cell boundaries f32-vs-f64 truncation
        # legitimately picks different cells, so keep the polygon mid-cell.
        poly = np.array([[0.31, 0.21], [-0.29, 0.21], [-0.29, -0.19], [0.31, -0.19]])
        fp = mpc.Footprint.create(poly)
        got = float(mpc.footprint_cost(cm, fp, samples=8))
        want = npcm.footprint_cost(poly, samples=8)
        assert abs(got - want) < 1e-6

    def test_transform_matches_pose(self, footprint_np):
        fp = mpc.Footprint.create(footprint_np)
        pose = jnp.array([1.0, 2.0, np.pi / 2])
        moved = mpc.transform_footprint(pose, fp)
        # First vertex (0.3, 0.2) -> rotate 90° -> (-0.2, 0.3) + (1, 2).
        np.testing.assert_allclose(moved.vertices[0], [0.8, 2.3], atol=1e-6)

    def test_padding_excluded(self):
        fp = mpc.Footprint.create([[0.1, 0.1], [-0.1, 0.1], [0.0, -0.1]], max_vertices=8)
        cm = mpc.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0), resolution=0.05)
        assert float(mpc.footprint_cost(cm, fp, samples=8)) == 0.0


class TestCostmapFlatView:
    def test_with_flat_queries_bit_identical(self):
        """cost_at_cell / make_point_sampler must read identical values
        through the cached flat view (Costmap.with_flat) and the per-call
        reshape — including out-of-bounds lethality."""
        from neo_mpc_planner2_tpu.ops.costmap import (cost_at_world,
                                                      make_point_sampler)

        rng = np.random.default_rng(5)
        data = rng.uniform(0, 1, (48, 64)).astype(np.float32)
        cm = mpc.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05)
        cmf = cm.with_flat()
        assert cmf.flat.shape == (48 * 64,)
        wx = jnp.asarray(rng.uniform(-1.5, 2.5, 64), jnp.float32)
        wy = jnp.asarray(rng.uniform(-1.5, 2.5, 64), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(cost_at_world(cm, wx, wy)),
            np.asarray(cost_at_world(cmf, wx, wy)))
        s0 = make_point_sampler(cm, wx[0], wy[0], 0)
        s1 = make_point_sampler(cmf, wx[0], wy[0], 0)
        np.testing.assert_array_equal(np.asarray(s0(wx, wy)),
                                      np.asarray(s1(wx, wy)))

    def test_u8_gather_bit_identical_on_raw_grid(self):
        """flat_u8 sampling (cfg.solver_costmap_u8) decodes u8/255.0 — the
        exact encode of Costmap.from_nav2_costmap — so for raw-grid maps the
        sampler values are bit-identical to the f32 gather, including the
        ==1.0 lethal cells and out-of-bounds lethality."""
        from neo_mpc_planner2_tpu.ops.costmap import make_point_sampler

        rng = np.random.default_rng(7)
        raw = rng.integers(0, 256, (48, 64)).astype(np.uint8)
        raw[10:14, 20:24] = 255  # lethal block must survive the roundtrip
        cm = mpc.Costmap.from_nav2_costmap(raw, origin=(-1.0, -1.0),
                                           resolution=0.05)
        wx = jnp.asarray(rng.uniform(-1.5, 2.5, 128), jnp.float32)
        wy = jnp.asarray(rng.uniform(-1.5, 2.5, 128), jnp.float32)
        sf = make_point_sampler(cm.with_flat(), wx[0], wy[0], 0)
        su = make_point_sampler(cm.with_flat(u8=True), wx[0], wy[0], 0)
        np.testing.assert_array_equal(np.asarray(sf(wx, wy)),
                                      np.asarray(su(wx, wy)))

    def test_u8_gather_quantization_bound_off_grid(self):
        """Maps with arbitrary float values quantize to the nearest /255 step:
        error <= 1/510 (the documented opt-in semantics)."""
        from neo_mpc_planner2_tpu.ops.costmap import make_point_sampler

        rng = np.random.default_rng(8)
        data = rng.uniform(0, 1, (32, 32)).astype(np.float32)
        cm = mpc.Costmap.create(data, origin=(0.0, 0.0), resolution=0.05)
        wx = jnp.asarray(rng.uniform(0.0, 1.6, 64), jnp.float32)
        wy = jnp.asarray(rng.uniform(0.0, 1.6, 64), jnp.float32)
        sf = make_point_sampler(cm.with_flat(), wx[0], wy[0], 0)
        su = make_point_sampler(cm.with_flat(u8=True), wx[0], wy[0], 0)
        diff = np.abs(np.asarray(sf(wx, wy)) - np.asarray(su(wx, wy)))
        assert diff.max() <= 1.0 / 510.0 + 1e-7

    def test_batched_with_flat(self):
        rng = np.random.default_rng(6)
        data = rng.uniform(0, 1, (4, 32, 32)).astype(np.float32)
        cm = mpc.Costmap(
            data=jnp.asarray(data),
            origin=jnp.tile(jnp.asarray([-0.8, -0.8], jnp.float32), (4, 1)),
            resolution=jnp.full((4,), 0.05, jnp.float32)).with_flat()
        assert cm.flat.shape == (4, 32 * 32)
        wx = jnp.asarray(rng.uniform(-1, 1, (4, 5)), jnp.float32)
        wy = jnp.asarray(rng.uniform(-1, 1, (4, 5)), jnp.float32)
        from neo_mpc_planner2_tpu.ops.costmap import cost_at_world
        got = jax.vmap(cost_at_world)(cm, wx, wy)
        want = jax.vmap(cost_at_world)(
            mpc.Costmap(data=cm.data, origin=cm.origin,
                        resolution=cm.resolution), wx, wy)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


class TestExtractWindowOnehot:
    """extract_window_onehot — the gather-free batched dynamic_slice (a
    vmapped dynamic_slice lowers to a gather)."""

    def test_matches_dynamic_slice(self):
        from neo_mpc_planner2_tpu.ops.costmap import extract_window_onehot
        rng = np.random.default_rng(7)
        data = rng.uniform(0, 1, (37, 53)).astype(np.float32)
        d = jnp.asarray(data)
        for (row, col, hc, wc) in [(0, 0, 5, 8), (31, 44, 6, 9),
                                   (12, 3, 1, 1), (0, 48, 37, 5)]:
            got = extract_window_onehot(d, jnp.int32(row), jnp.int32(col),
                                        hc, wc)
            want = jax.lax.dynamic_slice(d, (row, col), (hc, wc))
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_out_of_range_corner_clamps(self):
        """Out-of-range (row, col) clamp to the dynamic_slice corner (the
        one-hot would otherwise silently read zeros — advisor round 4)."""
        from neo_mpc_planner2_tpu.ops.costmap import extract_window_onehot
        rng = np.random.default_rng(9)
        data = rng.uniform(0, 1, (20, 25)).astype(np.float32)
        d = jnp.asarray(data)
        for (row, col) in [(-3, 5), (5, -2), (18, 5), (5, 23), (99, -99)]:
            got = extract_window_onehot(d, jnp.int32(row), jnp.int32(col),
                                        4, 6)
            want = jax.lax.dynamic_slice(d, (row, col), (4, 6))
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_batched_per_lane_offsets(self):
        from neo_mpc_planner2_tpu.ops.costmap import extract_window_onehot
        rng = np.random.default_rng(8)
        B, H, W, U = 5, 24, 30, 7
        data = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
        rows = rng.integers(0, H - U, B).astype(np.int32)
        cols = rng.integers(0, W - U, B).astype(np.int32)
        got = jax.vmap(lambda d, r, c: extract_window_onehot(d, r, c, U, U))(
            jnp.asarray(data), jnp.asarray(rows), jnp.asarray(cols))
        for b in range(B):
            np.testing.assert_array_equal(
                np.asarray(got[b]),
                data[b, rows[b]:rows[b] + U, cols[b]:cols[b] + U])


class TestUpdateWindow:
    """Costmap.update_window — the incremental (dirty-window) update path the
    reference inherits from its live ROS costmap (round-3 verdict item 2)."""

    def test_oversize_block_rejected(self):
        """A block larger than the map must raise (the dynamic_update_slice
        formulation rejected it at trace time; the one-hot blend would
        silently write zeros)."""
        import pytest
        cm = mpc.Costmap.create(np.zeros((8, 8), np.float32))
        with pytest.raises(ValueError, match="exceeds the map"):
            cm.update_window(jnp.ones((9, 4)), (0, 0))
        with pytest.raises(ValueError, match="exceeds the map"):
            cm.update_window(jnp.ones((4, 9)), (0, 0))

    def _rand_cm(self, seed=11, shape=(48, 64), flat=False, u8=False):
        rng = np.random.default_rng(seed)
        data = rng.uniform(0, 0.9, shape).astype(np.float32)
        cm = mpc.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05)
        if flat or u8:
            cm = cm.with_flat(u8=u8)
        return cm, data

    def test_update_matches_numpy(self):
        cm, data = self._rand_cm()
        rng = np.random.default_rng(12)
        block = rng.uniform(0, 1, (6, 9)).astype(np.float32)
        out = cm.update_window(jnp.asarray(block), (17, 30))
        want = data.copy()
        want[30:36, 17:26] = block
        np.testing.assert_array_equal(np.asarray(out.data), want)
        # Origin/resolution untouched; source map not mutated (functional).
        np.testing.assert_array_equal(np.asarray(cm.data), data)

    def test_flat_and_u8_views_refresh(self):
        """The cache invariant (ops/costmap.py flat docstring): an update on a
        flattened costmap must refresh flat AND flat_u8 in place so hoisted
        samplers never serve stale costs — bit-identically to a fresh map."""
        from neo_mpc_planner2_tpu.ops.costmap import (cost_at_world,
                                                      make_point_sampler)

        rng = np.random.default_rng(13)
        raw = rng.integers(0, 256, (48, 64)).astype(np.uint8)
        cm = mpc.Costmap.from_nav2_costmap(raw, origin=(-1.0, -1.0),
                                           resolution=0.05).with_flat(u8=True)
        block_raw = rng.integers(0, 256, (8, 8)).astype(np.uint8)
        block_raw[2:4, 3:5] = 255  # lethal cells must survive the u8 refresh
        block = block_raw.astype(np.float32) / 255.0
        out = cm.update_window(jnp.asarray(block), (20, 10))

        fresh_raw = raw.copy()
        fresh_raw[10:18, 20:28] = block_raw
        fresh = mpc.Costmap.from_nav2_costmap(
            fresh_raw, origin=(-1.0, -1.0), resolution=0.05).with_flat(u8=True)

        np.testing.assert_array_equal(np.asarray(out.flat),
                                      np.asarray(fresh.flat))
        np.testing.assert_array_equal(np.asarray(out.flat_u8),
                                      np.asarray(fresh.flat_u8))
        wx = jnp.asarray(rng.uniform(-1.2, 2.4, 128), jnp.float32)
        wy = jnp.asarray(rng.uniform(-1.2, 1.6, 128), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(cost_at_world(out, wx, wy)),
            np.asarray(cost_at_world(fresh, wx, wy)))
        # The u8 gather source (solver hot path) also reads the new block.
        s_out = make_point_sampler(out, wx[0], wy[0], 0)
        s_fresh = make_point_sampler(fresh, wx[0], wy[0], 0)
        np.testing.assert_array_equal(np.asarray(s_out(wx, wy)),
                                      np.asarray(s_fresh(wx, wy)))

    def test_vmapped_per_lane(self):
        rng = np.random.default_rng(14)
        data = rng.uniform(0, 1, (4, 32, 32)).astype(np.float32)
        cm = mpc.Costmap(data=jnp.asarray(data),
                         origin=jnp.tile(jnp.asarray([-1.0, -1.0]), (4, 1)),
                         resolution=jnp.full((4,), 0.05))
        blocks = rng.uniform(0, 1, (4, 5, 5)).astype(np.float32)
        los = np.array([[0, 0], [10, 3], [27, 27], [5, 20]], np.int32)
        out = jax.vmap(lambda c, b, l: c.update_window(b, l))(
            cm, jnp.asarray(blocks), jnp.asarray(los))
        for i in range(4):
            want = data[i].copy()
            want[los[i, 1]:los[i, 1] + 5, los[i, 0]:los[i, 0] + 5] = blocks[i]
            np.testing.assert_array_equal(np.asarray(out.data[i]), want)

    def test_corner_clamped_consistently(self):
        """An out-of-range corner clamps so the block fits — and the flat view
        gets the SAME clamped corner (a divergent clamp between the 2-D write
        and the flat row writes would silently desync the cached view)."""
        cm, data = self._rand_cm(flat=True)
        block = np.full((4, 4), 0.5, np.float32)
        out = cm.update_window(jnp.asarray(block), (62, 46))  # 62+4>64, 46+4>48
        want = data.copy()
        want[44:48, 60:64] = block
        np.testing.assert_array_equal(np.asarray(out.data), want)
        np.testing.assert_array_equal(np.asarray(out.flat), want.reshape(-1))

    def test_rolling_view_update(self):
        """Updates compose with the zero-copy rolling window: world cells
        update in place, the window moves by replacing win_lo, and samples
        match a freshly-built view of the same world."""
        from neo_mpc_planner2_tpu.ops.costmap import cost_at_world
        from neo_mpc_planner2_tpu.simulation import rolling_view

        rng = np.random.default_rng(15)
        world_data = rng.uniform(0, 0.9, (128, 128)).astype(np.float32)
        world = mpc.Costmap.create(world_data, origin=(-3.2, -3.2),
                                   resolution=0.05).with_flat()
        view = rolling_view(world, jnp.asarray([0.0, 0.0, 0.0]), 64)
        block = rng.uniform(0, 1, (6, 6)).astype(np.float32)
        upd = view.update_window(jnp.asarray(block), (70, 66))
        moved = rolling_view(upd, jnp.asarray([0.35, -0.2, 0.0]), 64)

        fresh_world = world_data.copy()
        fresh_world[66:72, 70:76] = block
        fresh = rolling_view(
            mpc.Costmap.create(fresh_world, origin=(-3.2, -3.2),
                               resolution=0.05).with_flat(),
            jnp.asarray([0.35, -0.2, 0.0]), 64)
        wx = jnp.asarray(rng.uniform(-3.5, 3.5, 256), jnp.float32)
        wy = jnp.asarray(rng.uniform(-3.5, 3.5, 256), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(cost_at_world(moved, wx, wy)),
            np.asarray(cost_at_world(fresh, wx, wy)))

    def test_nonfinite_cells_sanitized_locally(self):
        """NaN/Inf cells must not leak NaN outside the written window (the
        one-hot canvas would smear 0·inf — advisor round 4). Policy: NaN and
        +Inf read as lethal 1.0, -Inf as 0.0."""
        cm, data = self._rand_cm(flat=True, u8=True)
        block = np.full((4, 4), 0.5, np.float32)
        block[1, 1] = np.nan
        block[2, 0] = np.inf
        block[0, 3] = -np.inf
        out = cm.update_window(jnp.asarray(block), (10, 20))
        want = data.copy()
        clean = block.copy()
        clean[1, 1] = 1.0
        clean[2, 0] = 1.0
        clean[0, 3] = 0.0
        want[20:24, 10:14] = clean
        np.testing.assert_array_equal(np.asarray(out.data), want)
        assert np.all(np.isfinite(np.asarray(out.data)))
        np.testing.assert_array_equal(np.asarray(out.flat), want.reshape(-1))

    def test_update_under_jit(self):
        cm, data = self._rand_cm(flat=True)
        f = jax.jit(lambda c, b, l: c.update_window(b, l))
        block = np.full((3, 3), 0.25, np.float32)
        out = f(cm, jnp.asarray(block), jnp.asarray([5, 7], jnp.int32))
        want = data.copy()
        want[7:10, 5:8] = block
        np.testing.assert_array_equal(np.asarray(out.data), want)
        np.testing.assert_array_equal(np.asarray(out.flat), want.reshape(-1))
