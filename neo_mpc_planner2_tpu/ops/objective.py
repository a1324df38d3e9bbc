"""The MPC objective — all six cost terms of the reference, on device.

Reproduces mpc_optimization_server.py:204-269 (`MpcOptimizationServer.objective`)
as a pure, jit/vmap/grad-able function of the flat decision vector
(3 * control_steps,). Two modes:

- parity (cfg.compat defaults): bit-faithful to the reference's quirks —
  buggy odom yaw (py:213), footprint-aliasing no-op (py:227/238-244), the
  exact-equality lethal ×1000 branch (py:257-260), un-squared control cost
  (py:253-254), un-wrapped angle errors, nearest-cell costmap sampling, and the
  terminal translation term that is constant w.r.t. the decision variables
  (py:266 reads `curr_pos`, which is never advanced).
- product (`objective_product`): the smooth/intended variant — bilinear costmap
  sampling, true predicted-footprint cost, wrapped angle errors — giving useful
  analytic gradients for the fast solver path.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import MpcConfig
from .costmap import Costmap, cost_at_world, cost_at_world_bilinear
from .footprint import Footprint, footprint_cost, transform_footprint
from .rollout import rollout
from .se2 import wrap_angle
from ..utils import struct

__all__ = [
    "Scenario", "Weights", "Limits", "resolve_weights", "resolve_limits",
    "buggy_odom_yaw", "parity_footprint_term", "objective_parity",
    "objective_product", "make_objective",
]


@struct.dataclass
class Weights:
    """Per-scenario cost-weight overrides — the BASELINE.json "weight grids"
    batch axis. Each field is a scalar (or batched scalar under vmap); a
    None-valued Weights is replaced by the static config values, so a single
    compiled executable serves a whole weight grid.
    """

    w_trans: jnp.ndarray
    w_orient: jnp.ndarray
    w_control: jnp.ndarray
    w_terminal: jnp.ndarray
    w_costmap: jnp.ndarray
    w_footprint: jnp.ndarray

    @staticmethod
    def from_config(cfg: MpcConfig) -> "Weights":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return Weights(f(cfg.w_trans), f(cfg.w_orient), f(cfg.w_control),
                       f(cfg.w_terminal), f(cfg.w_costmap), f(cfg.w_footprint))

    @staticmethod
    def grid(cfg: MpcConfig, **axes) -> "Weights":
        """Cartesian weight grid, flattened to a batch: Weights.grid(cfg,
        w_trans=[0.5, 0.82], w_control=[0.01, 0.05, 0.2]) -> batch of 6."""
        names = ["w_trans", "w_orient", "w_control", "w_terminal",
                 "w_costmap", "w_footprint"]
        import numpy as np

        arrays = [np.asarray(axes.get(n, [getattr(cfg, n)]), np.float32)
                  for n in names]
        mesh = np.meshgrid(*arrays, indexing="ij")
        flat = [jnp.asarray(m.reshape(-1)) for m in mesh]
        return Weights(*flat)


@struct.dataclass
class Limits:
    """Runtime velocity/acceleration limits — the dynamic-reconfigure axis.

    The reference's cb_params (py:405-439) and the plugin's setSpeedLimit remap
    bounds at runtime without rebuilding anything; carrying them as a traced
    pytree (instead of static config closures) lets the solver's box/cone and
    the acceleration clamp update retrace-free: set new values, run the same
    compiled executable. A None-valued Limits on the Scenario falls back to the
    static config values.
    """

    vel_lo: jnp.ndarray        # (3,) min_vel_x, min_vel_y, min_vel_theta
    vel_hi: jnp.ndarray        # (3,) max_vel_x, max_vel_y, max_vel_theta
    max_vel_trans: jnp.ndarray  # () translational-speed cone radius
    acc: jnp.ndarray           # (3,) acc_x_limit, acc_y_limit, acc_theta_limit

    @staticmethod
    def from_config(cfg: MpcConfig) -> "Limits":
        f = lambda *v: jnp.asarray(v, jnp.float32)
        return Limits(
            vel_lo=f(cfg.min_vel_x, cfg.min_vel_y, cfg.min_vel_theta),
            vel_hi=f(cfg.max_vel_x, cfg.max_vel_y, cfg.max_vel_theta),
            max_vel_trans=jnp.asarray(cfg.max_vel_trans, jnp.float32),
            acc=f(cfg.acc_x_limit, cfg.acc_y_limit, cfg.acc_theta_limit),
        )

    def scaled(self, scale: float) -> "Limits":
        """Translational bounds scaled by a speed-limit fraction (setSpeedLimit
        'percentage from maximum robot speed'); yaw rate and accelerations
        untouched."""
        s = jnp.asarray(scale, jnp.float32)
        m = jnp.array([s, s, 1.0], jnp.float32)
        return Limits(vel_lo=self.vel_lo * m, vel_hi=self.vel_hi * m,
                      max_vel_trans=self.max_vel_trans * s, acc=self.acc)


@struct.dataclass
class Scenario:
    """One solve request — the device-resident analogue of the
    neo_srvs2/srv/Optimizer request (packed at NeoMpcPlanner.cpp:240-246)
    plus the server-side context it implies (costmap + footprint).

    current_pose: (3,) [x, y, yaw] in the costmap/odom frame.
    carrot_pose:  (3,) in the robot base frame (the transformed-plan frame,
                  NeoMpcPlanner.cpp:119-124).
    goal_pose:    (3,) in the global-plan (map) frame.
    current_vel:  (3,) [vx, vy, wz] body frame.
    footprint:    footprint polygon in the robot BASE frame. The reference
                  instead subscribes to the already-placed world-frame polygon
                  (/local_costmap/published_footprint, py:140-144); here the
                  world placement is derived as transform_footprint(
                  current_pose, footprint), which is exactly what nav2
                  publishes on that topic.
    costmap:      normalized local costmap.
    switch_opt:   () bool — closer_to_goal. Marshalled by the plugin (cpp:245)
                  and stored by the server (py:354) but never read afterwards;
                  kept for wire parity.
    """

    current_pose: jnp.ndarray
    carrot_pose: jnp.ndarray
    goal_pose: jnp.ndarray
    current_vel: jnp.ndarray
    footprint: Footprint
    costmap: Costmap
    switch_opt: jnp.ndarray
    # Optional per-scenario cost-weight overrides (Weights or None). None
    # means "use the static config values"; a Weights pytree batches under
    # vmap so one executable serves a whole weight grid.
    weights: "Weights | None" = None
    # Per-request control interval for the acceleration clamp. The reference
    # takes this from the service request (py:355; packed at cpp:246), NOT
    # from a server parameter. None -> cfg.control_interval.
    control_interval: "jnp.ndarray | None" = None
    # Optional runtime velocity/acceleration limits (Limits or None). None
    # means the static config bounds; a Limits pytree makes speed-limit and
    # cb_params-style bound updates retrace-free.
    limits: "Limits | None" = None

    @staticmethod
    def create(current_pose, carrot_pose, goal_pose, current_vel, footprint, costmap,
               switch_opt=False, weights=None, control_interval=None,
               limits=None) -> "Scenario":
        f32 = lambda a: jnp.asarray(a, jnp.float32)
        return Scenario(
            current_pose=f32(current_pose),
            carrot_pose=f32(carrot_pose),
            goal_pose=f32(goal_pose),
            current_vel=f32(current_vel),
            footprint=footprint,
            costmap=costmap,
            switch_opt=jnp.asarray(switch_opt, bool),
            weights=weights,
            control_interval=None if control_interval is None else f32(control_interval),
            limits=limits,
        )


def buggy_odom_yaw(current_yaw: jnp.ndarray, goal_yaw: jnp.ndarray) -> jnp.ndarray:
    """The reference's odom yaw (mpc_optimization_server.py:213): the current
    pose's quaternion (x, y, z) paired with the *goal* pose's w. For planar
    (pure-yaw) quaternions q_cur=(0,0,sin(c/2),cos(c/2)), w_goal=cos(g/2):

        yaw = atan2(2 * w_goal * z_cur, 1 - 2 * z_cur²)
    """
    zc = jnp.sin(current_yaw * 0.5)
    wg = jnp.cos(goal_yaw * 0.5)
    return jnp.arctan2(2.0 * wg * zc, 1.0 - 2.0 * zc * zc)


def resolve_weights(scen: "Scenario", cfg: MpcConfig) -> "Weights":
    """Per-scenario weights when provided, else the static config values."""
    return scen.weights if scen.weights is not None else Weights.from_config(cfg)


def resolve_limits(scen: "Scenario", cfg: MpcConfig) -> "Limits":
    """Per-scenario runtime limits when provided, else static config values
    (which XLA folds to constants — the zero-cost default path)."""
    return scen.limits if scen.limits is not None else Limits.from_config(cfg)


def control_cost(cmd_flat: jnp.ndarray, current_vel: jnp.ndarray, cfg: MpcConfig,
                 w_control=None) -> jnp.ndarray:
    """The control-effort term (py:253-254): w_control · Σ_i
    ‖current_vel − u_i‖ / N — the norm, NOT the squared norm, when
    CompatConfig.unsquared_control_cost (the reference behavior). Kept
    separate from the smooth terms so the solver can treat the nonsmooth norm
    by its proximal operator (block soft-threshold toward current_vel) instead
    of stalling on the kink at u_i == current_vel. With the flag off the term
    is the smooth squared norm (the conventional formulation).
    """
    cmd = cmd_flat.reshape(cfg.control_steps, 3)
    d2 = jnp.sum((current_vel[None, :] - cmd) ** 2, axis=-1)
    wc = cfg.w_control if w_control is None else w_control
    if cfg.compat.unsquared_control_cost:
        dv = jnp.where(d2 == 0.0, 0.0, jnp.sqrt(jnp.where(d2 == 0.0, 1.0, d2)))
        return wc * jnp.sum(dv) / cfg.control_steps
    return wc * jnp.sum(d2) / cfg.control_steps


def _stage_and_terminal(cfg, scen, cmd, body_traj, odom_traj, costmap_point_cost,
                        fp_term_per_step, orient_err_fn, include_control=True):
    """Shared cost accumulation across parity/product modes."""
    n = cfg.control_steps
    w = resolve_weights(scen, cfg)
    # Stage translation/orientation error vs the carrot (py:250-252).
    carrot_xy = scen.carrot_pose[:2]
    d2 = jnp.sum((carrot_xy[None, :] - body_traj[:, :2]) ** 2, axis=-1)  # (N,)
    oerr = orient_err_fn(scen.carrot_pose[2] - body_traj[:, 2])
    cost = jnp.sum(w.w_trans * d2 + w.w_orient * oerr**2) / n

    if include_control:
        cost += control_cost(cmd.reshape(-1), scen.current_vel, cfg, w.w_control)

    # Costmap term (py:257-260): squared point cost, ×1000 when the point is
    # exactly lethal, else ×w_costmap.
    sq = costmap_point_cost**2
    if cfg.compat.lethal_1000x:
        scale = jnp.where(costmap_point_cost == 1.0, 1000.0, w.w_costmap)
    else:
        scale = jnp.asarray(w.w_costmap, sq.dtype)
    cost += jnp.sum(scale * sq) / n

    # Footprint term.
    cost += jnp.sum(fp_term_per_step) / n

    # Terminal cost (py:266-268).
    term_o = orient_err_fn(scen.goal_pose[2] - body_traj[-1, 2])
    if cfg.compat.footprint_alias_noop:
        # Parity: curr_pos is the carrot (never advanced) and the goal is in
        # the map frame — the translation part is a constant offset (py:266).
        term_d2 = jnp.sum((carrot_xy - scen.goal_pose[:2]) ** 2)
    else:
        # Product: distance from the predicted terminal odom pose to the goal.
        term_d2 = jnp.sum((odom_traj[-1, :2] - scen.goal_pose[:2]) ** 2)
    cost += (w.w_trans * term_d2 + w.w_orient * term_o**2) * w.w_terminal
    return cost


def parity_footprint_term(scen: Scenario, cfg: MpcConfig) -> jnp.ndarray:
    """The (per-solve constant, see CompatConfig.footprint_alias_noop) footprint
    cost term: fires only when the current footprint touches lethal cost
    (py:262-263). Split out so solvers can hoist it out of the iteration loop —
    it does not depend on the decision variables."""
    fp_world = transform_footprint(scen.current_pose, scen.footprint)
    fp_cost = footprint_cost(scen.costmap, fp_world, cfg.footprint_edge_samples,
                             cfg.footprint_mode)
    w = resolve_weights(scen, cfg)
    return jnp.where(fp_cost == 1.0, fp_cost**2 * w.w_footprint, 0.0)


def objective_parity(
    cmd_flat: jnp.ndarray, scen: Scenario, cfg: MpcConfig,
    fp_term: jnp.ndarray | None = None, include_control: bool = True,
    point_sampler=None,
) -> jnp.ndarray:
    """Quirk-faithful objective. cmd_flat: (3N,) [vx0, vy0, w0, vx1, ...].

    fp_term: optional precomputed parity_footprint_term(scen, cfg).
    include_control: set False to get only the smooth terms (the solver adds
    the nonsmooth control term through its prox).
    point_sampler: optional (wx, wy) -> costs override for the per-step
    costmap lookup — solvers pass a patch-backed sampler (bit-identical
    values, hot-loop friendly; ops.costmap.CostmapPatch).
    """
    n = cfg.control_steps
    cmd = cmd_flat.reshape(n, 3)
    dt = jnp.asarray(cfg.dt, cmd.dtype)

    # Body-frame displacement rollout from the origin (py:230-232).
    body_traj = rollout(cmd, dt, jnp.zeros(3, cmd.dtype))

    # Odom rollout with the buggy yaw seed (py:213, :234-236).
    if cfg.compat.buggy_odom_yaw:
        yaw0 = buggy_odom_yaw(scen.current_pose[2], scen.goal_pose[2])
    else:
        yaw0 = scen.current_pose[2]
    odom0 = jnp.stack([scen.current_pose[0], scen.current_pose[1], yaw0])
    odom_traj = rollout(cmd, dt, odom0)

    # Nearest-cell costmap sample at each predicted odom position (py:246-247).
    sample = point_sampler if point_sampler is not None else (
        lambda wx, wy: cost_at_world(scen.costmap, wx, wy))
    pc = sample(odom_traj[:, 0], odom_traj[:, 1])  # (N,)

    if fp_term is None:
        fp_term = parity_footprint_term(scen, cfg)
    fp_per_step = jnp.full((n,), 1.0) * fp_term

    err_fn = (lambda e: e) if cfg.compat.no_angle_wrap else wrap_angle
    return _stage_and_terminal(
        cfg, scen, cmd, body_traj, odom_traj, pc, fp_per_step,
        orient_err_fn=err_fn, include_control=include_control,
    )


def objective_product(cmd_flat: jnp.ndarray, scen: Scenario, cfg: MpcConfig,
                      include_control: bool = True,
                      point_sampler=None) -> jnp.ndarray:
    """Smooth product-mode objective: bilinear costmap sampling, true predicted
    footprint cost, wrapped angle errors. Same weights and structure.

    point_sampler: optional per-solve hoisted sampler (a
    ops.costmap.ProductPatchSampler): the bilinear point costs and every
    footprint boundary sample then contract over its (P, P) patch instead of
    the full map — identical values inside the patch coverage guarantee,
    map-size-independent cost. Built automatically by the SQP lane closure
    when cfg.solver_costmap_patch > 0 (sqp._lane_fobj)."""
    n = cfg.control_steps
    cmd = cmd_flat.reshape(n, 3)
    dt = jnp.asarray(cfg.dt, cmd.dtype)

    body_traj = rollout(cmd, dt, jnp.zeros(3, cmd.dtype))
    odom_traj = rollout(cmd, dt, scen.current_pose)

    if point_sampler is None:
        pc = cost_at_world_bilinear(scen.costmap, odom_traj[:, 0],
                                    odom_traj[:, 1])
    else:
        pc = point_sampler.bilinear(odom_traj[:, 0], odom_traj[:, 1])
    fp_sample_fn = (None if point_sampler is None
                    or cfg.footprint_mode == "exact"
                    else point_sampler.nearest)

    def fp_at(i):
        return footprint_cost(
            scen.costmap,
            transform_footprint(odom_traj[i], scen.footprint),
            cfg.footprint_edge_samples,
            cfg.footprint_mode,
            sample_fn=fp_sample_fn,
        )

    fp_costs = jnp.stack([fp_at(i) for i in range(n)])
    fp_per_step = fp_costs**2 * resolve_weights(scen, cfg).w_footprint

    return _stage_and_terminal(
        cfg, scen, cmd, body_traj, odom_traj, pc, fp_per_step,
        orient_err_fn=wrap_angle, include_control=include_control,
    )


def make_objective(cfg: MpcConfig, parity: bool = True):
    """Close the config over the chosen objective: f(cmd_flat, scenario) -> cost.

    In parity mode the decision-variable-independent footprint term is hoisted:
    the returned callable recomputes it lazily per (traced) scenario, but
    solvers should prefer `objective_parity(..., fp_term=...)` with the term
    computed once per solve (make_solver does this automatically).
    """
    if parity:
        def f(cmd_flat, scen, fp_term=None, include_control=True,
              point_sampler=None):
            return objective_parity(cmd_flat, scen, cfg, fp_term=fp_term,
                                    include_control=include_control,
                                    point_sampler=point_sampler)
    else:
        def f(cmd_flat, scen, fp_term=None, include_control=True,
              point_sampler=None):
            del fp_term
            return objective_product(cmd_flat, scen, cfg,
                                     include_control=include_control,
                                     point_sampler=point_sampler)
    f.parity = parity
    f.cfg = cfg
    return f
