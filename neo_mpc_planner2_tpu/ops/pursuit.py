"""Pure-pursuit front-end: plan pruning, carrot selection, slow-down hysteresis.

Device-resident, batched re-design of the reference C++ plugin's per-tick
geometry (Layer A): transformGlobalPlan (NeoMpcPlanner.cpp:66-135),
getLookAheadDistance (:157-171), getLookAheadPoint (:173-189) and the
slow-down / collision gate (:216-236). The C++ host front-end in native/ mirrors
this for the single-robot path; this module is the vmap-able twin so thousands
of lookahead selections batch on chip.

Representation: the plan is a static-shape (P, 3) pose array with a valid
count; the reference's stateful prefix-erase (cpp:127) becomes a monotonic
`start` index carried in the controller state, which is behaviorally identical
(poses before the closest-point index are never candidates again).

Costs here are on the normalized [0, 1] scale; the plugin's raw-scale
thresholds map as 200/255 (inscribed-inflated gate, cpp:225/228) and 1.0
(lethal, cpp:234).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import MpcConfig
from .costmap import Costmap
from .footprint import Footprint, footprint_cost_at_pose
from .se2 import se2_inverse
from ..utils import struct

__all__ = ["Plan", "PursuitResult", "pursuit_tick", "SLOW_DOWN_COST_GATE", "LETHAL_GATE"]

# cpp:225/228 — footprint cost > 200 on the 0-255 scale.
SLOW_DOWN_COST_GATE = 200.0 / 255.0
# cpp:234 — footprint cost == 255 throws "MPC detected collision!".
LETHAL_GATE = 1.0

# Plain float (not a jnp constant: module import must not initialize a backend).
_BIG = 1e30


@struct.dataclass
class Plan:
    """Global plan in the map frame; (P,) component arrays + () int32 n_valid.

    Stored component-wise (px/py/pyaw) rather than as one (P, 3) array, so
    each batched component is one dense (B, P) buffer and the per-tick
    base-frame transform reads no 3-wide minor dimension. Use `.poses` for
    the (P, 3) view (host-side / convenience; it stacks on demand).
    """

    px: jnp.ndarray
    py: jnp.ndarray
    pyaw: jnp.ndarray
    n_valid: jnp.ndarray

    @property
    def poses(self) -> jnp.ndarray:
        """(P, 3) stacked view (materializes; avoid in device hot loops)."""
        return jnp.stack([self.px, self.py, self.pyaw], axis=-1)

    @staticmethod
    def from_poses(poses, n_valid) -> "Plan":
        p = jnp.asarray(poses, jnp.float32)
        return Plan(px=p[..., 0], py=p[..., 1], pyaw=p[..., 2],
                    n_valid=jnp.asarray(n_valid, jnp.int32))

    @staticmethod
    def create(poses, max_points: int = 128) -> "Plan":
        p = jnp.asarray(poses, jnp.float32)
        n = p.shape[0]
        if n == 0:
            # The reference throws "Received plan with zero length" from the
            # plugin (controller.py mirrors it); creating an empty Plan
            # directly is a caller bug — fail with the same clarity.
            raise ValueError("plan has zero length")
        if n > max_points:
            raise ValueError(f"plan has {n} poses > max {max_points}")
        pad = jnp.zeros((max_points - n, 3), jnp.float32) + p[-1]
        return Plan.from_poses(jnp.concatenate([p, pad], axis=0), n)

    def goal(self) -> jnp.ndarray:
        """Final pose (cpp:280)."""
        i = self.n_valid - 1
        return jnp.stack([self.px[i], self.py[i], self.pyaw[i]])


class PursuitResult(NamedTuple):
    carrot_pose: jnp.ndarray       # (3,) in base frame
    closer_to_goal: jnp.ndarray    # () bool
    slow_down: jnp.ndarray         # () bool — updated hysteresis state
    lethal: jnp.ndarray            # () bool — cpp:234's "MPC detected collision!"
    footprint_cost: jnp.ndarray    # () normalized current-pose footprint cost
    new_start: jnp.ndarray         # () int32 — consumed-prefix index
    lookahead_dist: jnp.ndarray    # () chosen lookahead distance
    plan_empty: jnp.ndarray        # () bool — window empty (cpp:130 throw)
    window_begin: jnp.ndarray      # () int32 — transformed-plan window [begin,
    window_end: jnp.ndarray        # () int32 — end) plan indices (cpp:102-124;
                                   # the received_global_plan debug path,
                                   # cpp:119-128, is these poses in base frame)


def _lookahead_distance(cfg: MpcConfig, slow_down, closer_to_goal):
    """getLookAheadDistance (cpp:157-171). The `speed` argument of the
    reference is ignored (SURVEY.md §2.3.2); min distance only applies when
    slowing down away from the goal."""
    d = jnp.where(
        jnp.logical_or(~slow_down, closer_to_goal),
        jnp.where(closer_to_goal, cfg.lookahead_dist_close_to_goal, cfg.lookahead_dist_max),
        cfg.lookahead_dist_min,
    )
    return jnp.asarray(d, jnp.float32)


def pursuit_tick(
    cfg: MpcConfig,
    plan: Plan,
    start: jnp.ndarray,
    slow_down: jnp.ndarray,
    robot_pose: jnp.ndarray,
    costmap: Costmap,
    base_footprint: Footprint,
) -> PursuitResult:
    """One plugin tick's geometry (cpp:208-238), pure and batchable.

    robot_pose is in the plan/map frame (the reference transforms the robot
    pose into the plan frame first, cpp:74-77; here both arrive in one frame).
    """
    P = plan.px.shape[0]
    idx = jnp.arange(P, dtype=jnp.int32)
    alive = (idx >= start) & (idx < plan.n_valid)

    # Closest pose (cpp:85-90). Component-wise on the (P,) plan arrays (see
    # Plan).
    dx = plan.px - robot_pose[0]
    dy = plan.py - robot_pose[1]
    d = jnp.sqrt(dx * dx + dy * dy)
    d_alive = jnp.where(alive, d, _BIG)
    begin = jnp.argmin(d_alive).astype(jnp.int32)

    # closer_to_goal (cpp:92-100): distance to the final plan pose.
    goal = plan.goal()
    closer_to_goal = jnp.linalg.norm(robot_pose[:2] - goal[:2]) <= cfg.lookahead_dist_close_to_goal

    # Window end: first pose at/after `begin` beyond half the costmap extent
    # (cpp:80-82, :102-106).
    max_dist = costmap.extent_world()
    beyond = (d > max_dist) & (idx >= begin) & alive
    end = jnp.min(jnp.where(beyond, idx, plan.n_valid)).astype(jnp.int32)

    window = (idx >= begin) & (idx < end) & (idx < plan.n_valid)
    plan_empty = ~jnp.any(window)

    # Transform window into the base frame (cpp:109-124) — the same math as
    # world_to_body(robot_pose, poses) (se2_compose ∘ se2_inverse), expanded
    # onto the component arrays so no padded (P, 3) buffer materializes.
    inv = se2_inverse(robot_pose)
    ci, si = jnp.cos(inv[2]), jnp.sin(inv[2])
    lx = inv[0] + plan.px * ci - plan.py * si
    ly = inv[1] + plan.px * si + plan.py * ci
    lyaw = inv[2] + plan.pyaw

    # Lookahead point (cpp:173-189): first window pose at ≥ lookahead_dist,
    # else the last window pose.
    lookahead_dist = _lookahead_distance(cfg, slow_down, closer_to_goal)
    far_enough = window & (jnp.sqrt(lx * lx + ly * ly) >= lookahead_dist)
    first_far = jnp.min(jnp.where(far_enough, idx, P)).astype(jnp.int32)
    last_window = jnp.max(jnp.where(window, idx, -1)).astype(jnp.int32)
    carrot_idx = jnp.where(first_far < P, first_far, jnp.maximum(last_window, 0))
    carrot = jnp.stack([lx[carrot_idx], ly[carrot_idx], lyaw[carrot_idx]])

    # Slow-down hysteresis + collision gate (cpp:216-236). The re-check at
    # cpp:224 calls getLookAheadPoint with identical arguments, so its branch
    # can never fire (SURVEY.md §2.3.3) — net behavior is the else-if chain.
    fp_cost = footprint_cost_at_pose(
        costmap, base_footprint, robot_pose, cfg.footprint_edge_samples,
        cfg.footprint_mode,
    )
    yaw_mag = jnp.abs(carrot[2])
    new_slow_down = jnp.where(
        yaw_mag < 1.0,
        False,
        (yaw_mag >= 1.0) & (fp_cost > SLOW_DOWN_COST_GATE),
    )
    lethal = fp_cost >= LETHAL_GATE

    return PursuitResult(
        carrot_pose=carrot,
        closer_to_goal=closer_to_goal,
        slow_down=new_slow_down,
        lethal=lethal,
        footprint_cost=fp_cost,
        new_start=begin,
        lookahead_dist=lookahead_dist,
        plan_empty=plan_empty,
        window_begin=begin,
        window_end=end,  # already clamped to n_valid by its construction
    )
