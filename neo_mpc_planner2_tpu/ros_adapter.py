"""Import-guarded ROS 2 adapter: run this engine as the reference's
`mpc_optimization_server` node inside a real rclpy stack.

The reference is a ROS-native two-process system (plugin cpp:202-254 ↔ rclpy
node py:441-447); this framework deliberately scopes ROS out of its core
(SURVEY.md §7 — no rclpy in the compute path, TCP/JSON serving instead). This
module is the BRIDGE for deployments that do run ROS 2: a drop-in twin of the
reference's server node (same node name, same 22 parameters, same `optimizer`
service semantics, same footprint subscription) backed by the device engine
through `serving.OptimizerSession`.

Design: everything testable is PURE — message translation (quaternion↔yaw
exactly as the reference computes it, py:160-196), request unpacking, and the
service-callback core operate on duck-typed message objects, so the full
translation layer is unit-tested without ROS. The rclpy wiring
(`RosOptimizerServer`, `main`) is a thin import-guarded shell: importing this
module never imports rclpy; constructing the node without rclpy raises a
clear error. This adapter has NOT been exercised against a live Nav2 stack
(no ROS in this environment) — the boundary is documented in
docs/MIGRATION.md.

Message shapes (duck-typed; matching neo_srvs2/srv/Optimizer as inferred in
SURVEY.md §2.1 C1):
  request.current_pose : PoseStamped   (.pose.position/.pose.orientation)
  request.carrot_pose  : PoseStamped
  request.goal_pose    : Pose          (.position/.orientation — no .pose,
                                        exactly like py:212/:266)
  request.current_vel  : Twist         (.linear/.angular)
  request.switch_opt   : bool
  request.control_interval : float
  response.output_vel  : TwistStamped  (.twist.linear/.twist.angular)
"""

from __future__ import annotations

import math
from typing import Any, Optional

from .config import MpcConfig, config_from_ros_params, default_config
from .serving import OptimizerSession

__all__ = [
    "HAVE_RCLPY", "euler_yaw_from_quaternion", "quaternion_from_yaw",
    "pose_to_xyyaw", "twist_to_vec", "request_to_msg", "fill_response",
    "optimizer_callback_core", "footprint_msg_to_points",
    "occupancy_values_to_cost", "occupancy_grid_to_costmap_msg",
    "occupancy_grid_update_to_msg", "costmap_refresh_op",
    "RosOptimizerServer", "main",
]

try:  # pragma: no cover - exercised only in a real ROS environment
    import rclpy  # type: ignore  # noqa: F401

    HAVE_RCLPY = True
except ImportError:
    HAVE_RCLPY = False


# ---------------------------------------------------------------------------
# Pure message translation (reference py:160-196 math, exactly)
# ---------------------------------------------------------------------------

def euler_yaw_from_quaternion(x: float, y: float, z: float, w: float) -> float:
    """Yaw extraction, same expression as the reference (py:176-178)."""
    t3 = 2.0 * (w * z + x * y)
    t4 = 1.0 - 2.0 * (y * y + z * z)
    return math.atan2(t3, t4)


def quaternion_from_yaw(yaw: float):
    """(w, x, y, z) like the reference's quaternion_from_euler(0, 0, yaw)
    (py:182-196 returns [w, x, y, z] for roll=pitch=0)."""
    return (math.cos(yaw * 0.5), 0.0, 0.0, math.sin(yaw * 0.5))


def pose_to_xyyaw(pose: Any) -> list:
    """geometry_msgs/Pose (or .pose of a PoseStamped) -> [x, y, yaw]."""
    p, q = pose.position, pose.orientation
    return [float(p.x), float(p.y),
            euler_yaw_from_quaternion(q.x, q.y, q.z, q.w)]


def twist_to_vec(tw: Any) -> list:
    """geometry_msgs/Twist -> [vx, vy, wz] (py:216-218 reads .linear.x/y and
    .angular.z)."""
    return [float(tw.linear.x), float(tw.linear.y), float(tw.angular.z)]


def request_to_msg(request: Any, delta_t: Optional[float] = None) -> dict:
    """Optimizer.srv request -> the serving-session optimizer op dict."""
    pose_stamped = request.current_pose
    carrot_stamped = request.carrot_pose
    msg = {
        "op": "optimizer",
        "current_pose": pose_to_xyyaw(pose_stamped.pose),
        "carrot_pose": pose_to_xyyaw(carrot_stamped.pose),
        # goal_pose is a bare Pose in the schema (accessed without .pose at
        # py:212/:266).
        "goal_pose": pose_to_xyyaw(request.goal_pose),
        "current_vel": twist_to_vec(request.current_vel),
        "switch_opt": bool(request.switch_opt),
        "control_interval": float(request.control_interval),
    }
    if delta_t is not None:
        msg["delta_t"] = float(delta_t)
    return msg


def fill_response(response: Any, result: dict) -> Any:
    """Serving result dict -> Optimizer.srv response. Like the reference,
    only output_vel.twist carries data (SURVEY.md §2.3.11 — headers are never
    populated here either; a caller that needs stamps must fill
    response.output_vel.header itself after this returns)."""
    v = result["output_vel"]
    tw = response.output_vel.twist
    tw.linear.x, tw.linear.y, tw.angular.z = float(v[0]), float(v[1]), float(v[2])
    return response


def optimizer_callback_core(session: OptimizerSession, request: Any,
                            response: Any,
                            delta_t: Optional[float] = None) -> Any:
    """The whole service callback, rclpy-free: unpack -> solve -> fill.

    Raises RuntimeError with the session's error string when the request is
    rejected (no costmap/footprint staged, non-finite input) — the rclpy
    shell converts that to a service failure log + zero command, which is
    safer than the reference's behavior of crashing the executor on a
    missing footprint (§2.3.10)."""
    result = session.handle(request_to_msg(request, delta_t))
    if "error" in result:
        raise RuntimeError(result["error"])
    return fill_response(response, result)


def footprint_msg_to_points(msg: Any) -> list:
    """geometry_msgs/PolygonStamped (the `/local_costmap/published_footprint`
    payload, py:140-144) -> [[x, y], ...] BASE-frame vertices."""
    return [[float(p.x), float(p.y)] for p in msg.polygon.points]


def occupancy_values_to_cost(data: Any, h: int, w: int) -> "np.ndarray":
    """Row-major occupancy values (int8: -1 unknown, 0..100 occupancy) ->
    (h, w) float32 normalized cost, -1 unknown -> lethal (nav2 convention).
    Vectorized: a 128² grid arrives continuously on the costmap topic and a
    Python per-cell loop inside the rclpy executor callback would starve the
    optimizer service."""
    import numpy as np

    arr = np.asarray(data, dtype=np.float32).reshape(h, w)
    return np.where(arr < 0, np.float32(1.0),
                    np.clip(arr / 100.0, 0.0, 1.0)).astype(np.float32)


def occupancy_grid_to_costmap_msg(msg: Any) -> dict:
    """nav_msgs/OccupancyGrid (the `/local_costmap/costmap` topic the
    reference's Costmap2d subscribes to, py:118) -> set_costmap op dict."""
    info = msg.info
    h, w = int(info.height), int(info.width)
    return {
        "op": "set_costmap",
        "data": occupancy_values_to_cost(msg.data, h, w),
        "origin": [float(info.origin.position.x),
                   float(info.origin.position.y)],
        "resolution": float(info.resolution),
    }


def occupancy_grid_update_to_msg(msg: Any) -> dict:
    """map_msgs/OccupancyGridUpdate (nav2's `/local_costmap/costmap_updates`
    topic — the dirty-window companion of the full grid) -> the serving
    set_costmap_update op: only the changed block crosses into the staged
    device map."""
    h, w = int(msg.height), int(msg.width)
    return {
        "op": "set_costmap_update",
        "data": occupancy_values_to_cost(msg.data, h, w),
        "lo": [int(msg.x), int(msg.y)],
    }


def _pow2_at_least(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


def costmap_refresh_op(prev_grid, prev_meta, grid, meta) -> Optional[dict]:
    """Cheapest serving op that brings the staged map from `prev_grid` to
    `grid` ((H, W) float32 cost arrays; meta = (origin_xy, resolution)).

    Full-grid messages keep arriving even when almost nothing changed; a
    full set_costmap restage per message pays Costmap.create + the whole
    flat/u8 relayout + a whole-grid device_put every time (the exact per-tick
    re-stage op_set_costmap_update exists to avoid). Diff against the
    previous grid and send only the dirty bounding box. Returns None when
    nothing changed; falls back to the full set_costmap op when there is no
    previous grid or the geometry moved (shape/origin/resolution — e.g. a
    rolling local costmap re-anchoring its origin).

    The dirty block is PADDED to power-of-two dimensions (clamped to the
    grid, corner shifted to stay in bounds): the serving session's update
    executable is shape-specialized (jit), so raw data-dependent bbox
    shapes would recompile on nearly every message. Padding bounds the
    distinct shapes at
    (log2 H + 1)·(log2 W + 1); padded cells carry `grid` values identical
    to what is already staged, so the write stays value-exact."""
    import numpy as np

    if prev_grid is None or prev_meta != meta or prev_grid.shape != grid.shape:
        return {"op": "set_costmap", "data": grid,
                "origin": list(meta[0]), "resolution": meta[1]}
    diff = prev_grid != grid
    if not diff.any():
        return None
    H, W = grid.shape
    rows = np.flatnonzero(diff.any(axis=1))
    cols = np.flatnonzero(diff.any(axis=0))
    r0, c0 = int(rows[0]), int(cols[0])
    ph = _pow2_at_least(int(rows[-1]) + 1 - r0, H)
    pw = _pow2_at_least(int(cols[-1]) + 1 - c0, W)
    r0 = min(r0, H - ph)
    c0 = min(c0, W - pw)
    return {"op": "set_costmap_update", "data": grid[r0:r0 + ph, c0:c0 + pw],
            "lo": [c0, r0]}


# ---------------------------------------------------------------------------
# rclpy shell (import-guarded; thin by construction)
# ---------------------------------------------------------------------------

class RosOptimizerServer:
    """rclpy node twin of the reference server (py:44-153): node name
    `mpc_optimization_server`, the same ROS parameters (declared from
    MpcConfig so names/defaults match py:49-75 1:1), service `optimizer`,
    subscriptions for the published footprint and the local costmap grid.

    srv_type: the neo_srvs2.srv.Optimizer class (passed in so this module
    never hard-imports neo_srvs2; any service type with the same fields
    works)."""

    def __init__(self, srv_type: Any, cfg: Optional[MpcConfig] = None):
        if not HAVE_RCLPY:
            raise ImportError(
                "rclpy is not available — RosOptimizerServer needs a ROS 2 "
                "environment; use `neo-mpc-server` (TCP/JSON) otherwise")
        import dataclasses

        from rclpy.node import Node  # type: ignore

        class _Node(Node):
            pass

        self.node = _Node("mpc_optimization_server")
        base = cfg or default_config()
        # Declare the reference's parameter surface and read overrides.
        params = {}
        for f in dataclasses.fields(MpcConfig):
            if f.name == "compat":
                continue
            v = getattr(base, f.name)
            if isinstance(v, (int, float, bool, str)):
                self.node.declare_parameter(f.name, v)
                params[f.name] = self.node.get_parameter(f.name).value
        self.session = OptimizerSession(config_from_ros_params(params,
                                                               base=base))
        self.srv = self.node.create_service(srv_type, "optimizer",
                                            self._on_optimize)
        # Last staged grid, for diffing full-grid messages down to their
        # dirty bounding box (costmap_refresh_op). Set before the
        # subscriptions exist so no callback can observe a missing attribute.
        self._last_grid = None
        self._last_meta = None
        # True after the baseline was DROPPED (oversize update / rejected
        # stage) rather than never seen: raw updates must then be discarded,
        # not forwarded, until a full grid restages — forwarding would merge
        # new-geometry deltas into the stale staged map at wrong world cells.
        self._baseline_dropped = False
        from geometry_msgs.msg import PolygonStamped  # type: ignore
        from nav_msgs.msg import OccupancyGrid  # type: ignore

        self.node.create_subscription(
            PolygonStamped, "/local_costmap/published_footprint",
            self._on_footprint, 10)
        self.node.create_subscription(
            OccupancyGrid, "/local_costmap/costmap", self._on_costmap, 1)
        # nav2 publishes dirty windows on the companion updates topic; ride
        # them straight into op_set_costmap_update (map_msgs is optional).
        try:  # pragma: no cover - needs ROS
            from map_msgs.msg import OccupancyGridUpdate  # type: ignore

            self.node.create_subscription(
                OccupancyGridUpdate, "/local_costmap/costmap_updates",
                self._on_costmap_update, 10)
        except ImportError:
            pass
        self.node.add_on_set_parameters_callback(self._on_params)

    def _on_footprint(self, msg: Any) -> None:
        self.session.handle({"op": "set_footprint",
                             "points": footprint_msg_to_points(msg)})

    def _apply_refresh(self, grid, meta) -> None:
        """Stage `grid` via the cheapest op; keep the diff baseline in sync
        with what the device ACTUALLY holds. On a rejected stage the
        baseline is dropped (None) so the next message full-restages —
        silently advancing it would exclude this message's delta from every
        future dirty-bbox diff, leaving the staged map permanently stale."""
        op = costmap_refresh_op(self._last_grid, self._last_meta, grid, meta)
        if op is not None:
            r = self.session.handle(op)
            if "error" in r:
                self.node.get_logger().warn(
                    f"costmap stage rejected: {r['error']}")
                self._last_grid, self._last_meta = None, None
                self._baseline_dropped = True
                return
        self._last_grid, self._last_meta = grid, meta
        self._baseline_dropped = False

    def _on_costmap(self, msg: Any) -> None:
        info = msg.info
        grid = occupancy_values_to_cost(msg.data, int(info.height),
                                        int(info.width))
        meta = ((float(info.origin.position.x),
                 float(info.origin.position.y)), float(info.resolution))
        self._apply_refresh(grid, meta)

    def _on_costmap_update(self, msg: Any) -> None:
        op = occupancy_grid_update_to_msg(msg)
        if self._last_grid is None:
            if self._baseline_dropped:
                # The baseline was dropped (geometry-change race / rejected
                # stage), not merely unseen: the staged device map is stale,
                # so applying raw update cells would merge new-geometry
                # content at wrong world positions. Discard until the next
                # periodic full grid restages.
                self.node.get_logger().warn(
                    "costmap update discarded: awaiting full-grid restage")
                return
            # Pristine startup (no full grid seen by THIS adapter): forward
            # best-effort — another client may have staged one; the serving
            # session errors harmlessly if not.
            self.session.handle(op)
            return
        h, w = op["data"].shape
        x, y = op["lo"]
        if y + h > self._last_grid.shape[0] or x + w > self._last_grid.shape[1]:
            # Update window exceeds the last staged grid — after a geometry
            # change, updates for the NEW grid can race ahead of the full
            # grid message (nav2 publishes full grids periodically, updates
            # in between; ordering between the two topics is not
            # guaranteed). Drop the diff baseline so the next full grid
            # restages UNCONDITIONALLY — otherwise every update until then
            # would diff against (and silently merge into) stale geometry.
            self.node.get_logger().warn("costmap update outside the grid")
            self._last_grid, self._last_meta = None, None
            self._baseline_dropped = True
            return
        # Merge into the baseline and restage through the padded-bbox diff
        # path — same canonical block shapes as full-grid messages, so the
        # serving executable set stays bounded.
        grid = self._last_grid.copy()
        grid[y:y + h, x:x + w] = op["data"]
        self._apply_refresh(grid, self._last_meta)

    def _on_params(self, params) -> Any:
        from rcl_interfaces.msg import SetParametersResult  # type: ignore

        update = {p.name: p.value for p in params}
        r = self.session.handle({"op": "configure", "params": update})
        return SetParametersResult(successful="error" not in r)

    def _on_optimize(self, request: Any, response: Any) -> Any:
        try:
            return optimizer_callback_core(self.session, request, response)
        except RuntimeError as e:
            # Safer than the reference's footprint-race crash (§2.3.10):
            # log + zero command.
            self.node.get_logger().warn(f"optimizer request rejected: {e}")
            return response

    def spin(self) -> None:  # pragma: no cover - needs ROS
        import rclpy  # type: ignore

        rclpy.spin(self.node)


def main(argv=None) -> None:  # pragma: no cover - needs ROS
    """`ros2 run`-style entry (reference py:441-447). Requires rclpy and
    neo_srvs2 in the environment."""
    import rclpy  # type: ignore
    from neo_srvs2.srv import Optimizer  # type: ignore

    rclpy.init(args=argv)
    RosOptimizerServer(Optimizer).spin()
