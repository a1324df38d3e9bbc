"""The MPC engine: one pure, batched, device-resident controller step.

Collapses the reference's entire two-process tick — C++ plugin geometry
(NeoMpcPlanner.cpp:202-254) → blocking ROS service (cpp:248-250) → Python
SLSQP server with post-processing (mpc_optimization_server.py:349-403) — into a
single jittable function of (config, state, inputs). The stateful control-loop
memory the reference keeps in the server (initial_guess py:136, last_control
py:117, waiting_time py:361, old_goal py:146) and in the plugin (slow_down_
h:162, consumed plan prefix cpp:127) lives in one explicit `ControlState`
pytree, so it is batchable over scenarios, shardable over a mesh, and trivially
checkpointable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import MpcConfig
from .ops.costmap import Costmap, cost_at_world, u8_source_enabled
from .ops.footprint import Footprint, footprint_cost, transform_footprint
from .ops.objective import Scenario, make_objective
from .ops.pursuit import Plan, pursuit_tick
from .ops.rollout import rollout
from .utils import struct


__all__ = ["ControlState", "StepResult", "init_state", "solve_step",
           "controller_step", "make_batched_controller_step", "MpcEngine"]


@struct.dataclass
class ControlState:
    """Per-scenario persistent control-loop memory (SURVEY.md §5 checkpoint row)."""

    initial_guess: jnp.ndarray   # (3N,) warm start (py:136)
    last_control: jnp.ndarray    # (3,) previous command (py:117)
    waiting_time: jnp.ndarray    # () stuck-wait accumulator (py:361)
    collision: jnp.ndarray       # () bool — sticky predicted-collision latch (py:339)
    old_goal: jnp.ndarray        # (3,) goal of the previous tick (py:146)
    has_old_goal: jnp.ndarray    # () bool — False forces the first-call reset
    slow_down: jnp.ndarray       # () bool — plugin hysteresis (h:162, init true)
    plan_start: jnp.ndarray      # () int32 — consumed plan prefix (cpp:127)


def init_state(cfg: MpcConfig) -> ControlState:
    n = cfg.control_steps
    return ControlState(
        initial_guess=jnp.zeros(3 * n, jnp.float32),
        last_control=jnp.zeros(3, jnp.float32),
        waiting_time=jnp.float32(0.0),
        collision=jnp.asarray(False),
        old_goal=jnp.zeros(3, jnp.float32),
        has_old_goal=jnp.asarray(False),
        slow_down=jnp.asarray(True),
        plan_start=jnp.int32(0),
    )


class StepResult(NamedTuple):
    cmd_vel: jnp.ndarray          # (3,) the answer — output_vel.twist equivalent
    state: ControlState           # updated persistent state
    raw_solution: jnp.ndarray     # (3N,) solver output before filtering
    solver_converged: jnp.ndarray
    solver_iters: jnp.ndarray
    fun: jnp.ndarray              # final objective value
    collision: jnp.ndarray        # predicted-collision latch after this tick
    collision_footprint: jnp.ndarray
    lethal: jnp.ndarray           # plugin-side hard stop (cpp:234-236)
    plan_empty: jnp.ndarray       # transformed-plan window empty (cpp:130-132)
    carrot_pose: jnp.ndarray
    closer_to_goal: jnp.ndarray
    local_plan: jnp.ndarray       # (N+1, 3) current pose + RAW-solution rollout
                                  # (publishLocalPlan, py:284-305 — published at
                                  # py:365 BEFORE the low-pass at py:366-367)
    plan_window_begin: jnp.ndarray  # () int32 — transformed-plan window
    plan_window_end: jnp.ndarray    # [begin, end) plan indices; the
                                    # received_global_plan debug artifact
                                    # (cpp:119-128) is these poses in base frame


def _shift_warm_start(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """initial_guess_update (py:198-202): shift controls left one step, wrap the
    (low-passed) first control to the back."""
    xs = x.reshape(n, 3)
    shifted = jnp.concatenate([xs[1:], xs[:1]], axis=0)
    return shifted.reshape(-1)


def _pre_solve(cfg: MpcConfig, state: ControlState, scen: Scenario):
    """New-goal reset (py:357-361): returns (guess, last_control, waiting_time)
    — the solver warm start and the post-processing context for this tick."""
    same_goal = state.has_old_goal & jnp.all(state.old_goal == scen.goal_pose)
    guess = jnp.where(same_goal, state.initial_guess, jnp.zeros_like(state.initial_guess))
    last_control = jnp.where(same_goal, state.last_control, jnp.zeros_like(state.last_control))
    waiting_time = jnp.where(same_goal, state.waiting_time, 0.0)
    return guess, last_control, waiting_time


def _post_solve(
    cfg: MpcConfig,
    state: ControlState,
    scen: Scenario,
    delta_t: jnp.ndarray,
    res,
    last_control: jnp.ndarray,
    waiting_time: jnp.ndarray,
    fp_cost: "jnp.ndarray | None" = None,
) -> StepResult:
    """Everything after the solve (py:365-403): visualization, low-pass,
    collision/stuck logic, acceleration clamp, state persistence."""
    n = cfg.control_steps

    # --- local-plan visualization (py:365 → publishLocalPlan py:271-310):
    # the RAW solution re-integrated from the current pose (correct TF yaw),
    # with the current pose itself as the leading element (py:284-291). The
    # publish happens BEFORE the low-pass, so this uses res.x, not x.
    viz_traj = rollout(res.x.reshape(n, 3), jnp.asarray(cfg.dt, res.x.dtype),
                       scen.current_pose)
    local_plan = jnp.concatenate([scen.current_pose[None], viz_traj], axis=0)

    # --- low-pass the first control only (py:366-367) ---
    g = jnp.asarray(cfg.low_pass_gain, res.x.dtype)
    first = res.x[:3] * g + last_control * (1.0 - g)
    x = res.x.at[:3].set(first)

    # --- predicted-collision check (py:312-347): correct-yaw odom rollout ---
    odom_traj = rollout(x.reshape(n, 3), jnp.asarray(cfg.dt, x.dtype), scen.current_pose)
    point_costs = cost_at_world(scen.costmap, odom_traj[:, 0], odom_traj[:, 1])
    detected = jnp.any(point_costs >= 0.99)
    collision = state.collision | detected
    # Goal reset does NOT clear the collision latch in the reference; keep as-is.

    # Current-pose footprint cost: identical to the pursuit gate's
    # footprint_cost_at_pose (same pose/footprint/map/sampling), so the full
    # tick passes that value in rather than evaluating the polygon twice per
    # tick; the standalone server path (no pursuit) computes it here.
    if fp_cost is None:
        fp_world = transform_footprint(scen.current_pose, scen.footprint)
        fp_cost = footprint_cost(scen.costmap, fp_world,
                                 cfg.footprint_edge_samples,
                                 cfg.footprint_mode)
    collision_footprint = fp_cost == 1.0

    # --- stuck-wait vs acceleration clamp (py:374-391) ---
    blocked = collision | collision_footprint
    waiting_time = jnp.where(blocked, waiting_time + delta_t, waiting_time)
    # Parity: hardcoded 3.0 s threshold (py:380; the waiting_time *param* is
    # hijacked as the accumulator — SURVEY.md §2.3.6). Product mode honors
    # cfg.waiting_time as the threshold the parameter doc promises (py:70).
    stuck_thresh = (3.0 if cfg.compat.hardcoded_stuck_wait
                    else cfg.waiting_time)
    expire = blocked & (waiting_time >= stuck_thresh)
    collision = jnp.where(expire, False, collision)
    waiting_time = jnp.where(expire, 0.0, waiting_time)

    # The clamp interval comes from the request when provided (py:355 — the
    # reference uses request.control_interval, not a server parameter).
    ci = (jnp.asarray(cfg.control_interval, x.dtype)
          if scen.control_interval is None
          else jnp.asarray(scen.control_interval, x.dtype))
    if scen.limits is None:
        acc_lim = jnp.array([cfg.acc_x_limit, cfg.acc_y_limit,
                             cfg.acc_theta_limit], x.dtype)
    else:
        acc_lim = jnp.asarray(scen.limits.acc, x.dtype)
    acc = acc_lim * ci
    # fmin/fmax, NOT minimum/maximum: the reference clamps with np.fmin/fmax
    # (py:384-391; oracle.py mirrors it), which IGNORE a NaN operand — so a
    # diverged solve's NaN command clamps to the finite last_control±acc band
    # instead of propagating NaN into cmd_vel and poisoning last_control for
    # every later tick (round-5 review; identical for finite inputs).
    clamped = jnp.fmax(jnp.fmin(x[:3], last_control + acc), last_control - acc)
    cmd = jnp.where(blocked, jnp.zeros(3, x.dtype), clamped)

    # --- persist (py:393-400) ---
    new_guess = jnp.where(res.converged, _shift_warm_start(x, n), x)
    new_state = ControlState(
        initial_guess=new_guess,
        last_control=cmd,
        waiting_time=waiting_time,
        collision=collision,
        old_goal=scen.goal_pose,
        has_old_goal=jnp.asarray(True),
        slow_down=state.slow_down,
        plan_start=state.plan_start,
    )
    return StepResult(
        cmd_vel=cmd,
        state=new_state,
        raw_solution=res.x,
        solver_converged=res.converged,
        solver_iters=res.iters,
        fun=res.fun,
        collision=collision,
        collision_footprint=collision_footprint,
        lethal=jnp.asarray(False),
        plan_empty=jnp.asarray(False),
        carrot_pose=scen.carrot_pose,
        closer_to_goal=scen.switch_opt,
        local_plan=local_plan,
        plan_window_begin=jnp.int32(0),
        plan_window_end=jnp.int32(0),
    )


def solve_step(
    cfg: MpcConfig,
    state: ControlState,
    scen: Scenario,
    delta_t: jnp.ndarray,
    *,
    parity: bool = True,
    solver=None,
    fp_cost=None,
) -> StepResult:
    """The optimization-server half of the tick (py:349-403), pure.

    delta_t: wall-clock seconds since the previous tick — the reference derives
    it from time.time() (py:369-371); under jit it is an explicit input.
    fp_cost: optional precomputed current-pose footprint cost (the pursuit
    gate already evaluates the identical polygon; see _post_solve).
    """
    guess, last_control, waiting_time = _pre_solve(cfg, state, scen)

    # --- solve (py:363-364) ---
    if solver is None:
        # SQP is the SLSQP-parity solver (sqp.py); the prox-FISTA path
        # (solver.py) serves the smooth product objective.
        from .sqp import make_sqp_solver

        solver = make_sqp_solver(cfg, make_objective(cfg, parity=parity))
    res = solver(guess, scen)
    return _post_solve(cfg, state, scen, delta_t, res, last_control,
                       waiting_time, fp_cost=fp_cost)


def controller_step(
    cfg: MpcConfig,
    state: ControlState,
    plan: Plan,
    robot_pose: jnp.ndarray,
    current_vel: jnp.ndarray,
    costmap: Costmap,
    base_footprint: Footprint,
    delta_t: jnp.ndarray,
    *,
    parity: bool = True,
    solver=None,
    limits=None,
) -> StepResult:
    """The FULL tick: plugin geometry + solve + post-processing.

    Equivalent of computeVelocityCommands (cpp:202-254) with the service hop
    replaced by an in-graph call. The cpp:234-236 ControllerException becomes
    the `lethal` flag (host decides whether to raise).

    limits: optional runtime Limits pytree (speed-limit / dynamic-reconfigure
    bounds) applied to the solver box/cone and the acceleration clamp without
    retracing.
    """
    pr, scen, state = _tick_pre(cfg, state, plan, robot_pose, current_vel,
                                costmap, base_footprint, limits)
    out = solve_step(cfg, state, scen, delta_t, parity=parity, solver=solver,
                     fp_cost=pr.footprint_cost)
    return _tick_post(pr, state, out)


def _tick_pre(cfg, state, plan, robot_pose, current_vel, costmap,
              base_footprint, limits):
    """Plugin-side geometry + hysteresis-state update for one tick."""
    pr = pursuit_tick(
        cfg, plan, state.plan_start, state.slow_down, robot_pose, costmap, base_footprint
    )
    scen = Scenario(
        current_pose=robot_pose,
        carrot_pose=pr.carrot_pose,
        goal_pose=plan.goal(),
        current_vel=current_vel,
        footprint=base_footprint,
        costmap=costmap,
        switch_opt=pr.closer_to_goal,
        limits=limits,
    )
    slow_down_new = jnp.where(pr.plan_empty, state.slow_down, pr.slow_down)
    return pr, scen, state.replace(slow_down=slow_down_new,
                                   plan_start=pr.new_start)


def _tick_post(pr, state: ControlState, out: StepResult) -> StepResult:
    """Plugin-gate merge: the reference throws BEFORE the optimizer service
    call on both plugin gates — empty transformed plan (cpp:130-132, after the
    cpp:127 prefix erase but before the hysteresis update) and the lethal
    footprint (cpp:234-236, after the hysteresis update) — so the server state
    (initial_guess, last_control, waiting_time, old_goal) is untouched on
    those ticks. Mirror that: the solve ran unconditionally (fused graph);
    discard its state writes when a gate fired."""
    skip = pr.lethal | pr.plan_empty
    kept_state = jax.tree.map(lambda pre, post: jnp.where(skip, pre, post),
                              state, out.state)
    cmd = jnp.where(skip, jnp.zeros_like(out.cmd_vel), out.cmd_vel)
    # The discarded solve's flags must not leak either: on a gate tick the
    # reference never ran the server, so there are no solve-derived collision
    # flags to report — leaking them made the response contradict the kept
    # (pre-tick) latch state a client then observes next tick (round-5
    # review). Solver diagnostics are masked to the no-solve defaults too.
    f = jnp.asarray(False)
    return out._replace(
        cmd_vel=cmd,
        state=kept_state,
        collision=jnp.where(skip, state.collision, out.collision),
        collision_footprint=jnp.where(skip, f, out.collision_footprint),
        solver_converged=jnp.where(skip, f, out.solver_converged),
        lethal=pr.lethal,
        plan_empty=pr.plan_empty,
        carrot_pose=pr.carrot_pose,
        closer_to_goal=pr.closer_to_goal,
        plan_window_begin=pr.window_begin,
        plan_window_end=pr.window_end,
    )


def make_batched_controller_step(cfg: MpcConfig, parity: bool = True,
                                 solver_batch=None):
    """Build the batched full-tick function with lockstep-tail compaction.

    Functionally identical to vmap(controller_step) — same per-lane math, same
    signature with a leading batch axis on every argument — but the solve runs
    through sqp.make_sqp_solver_batched, which re-batches straggler lanes into
    a compact sub-batch after cfg.solver_compact_after iterations instead of
    dragging the whole batch through the lockstep tail (values match to ~1e-6
    float-fusion reassociation when the compact branch fires; see sqp.py). This is the batch path
    used by MpcEngine.batch_step and simulation.batch_simulate; the sharded
    fleet path (parallel.ShardedEngine) keeps plain vmap so the gather/scatter
    never crosses shard boundaries.
    """
    if solver_batch is None:
        from .sqp import make_sqp_solver_batched

        solver_batch = make_sqp_solver_batched(
            cfg, make_objective(cfg, parity=parity))

    def step(state, plan, robot_pose, current_vel, costmap, footprint,
             delta_t, limits=None):
        # Hoist the flat costmap view to once per call: every downstream
        # consumer (solver point sampler, pursuit gates, collision rollout)
        # otherwise pays the (H, W) -> (H*W,) relayout copy at its own
        # consumption site (ops.costmap.Costmap.flat). Callers that loop
        # ticks (batch_simulate) hoist it once outside their scan instead.
        u8 = u8_source_enabled(
            cfg.solver_costmap_u8,
            costmap.data.shape[-2] * costmap.data.shape[-1])
        if costmap.flat is None or (u8 and costmap.flat_u8 is None):
            costmap = costmap.with_flat(u8=u8)

        def pre(st, p, rp, cv, cm, fp, lim):
            pr, scen, st2 = _tick_pre(cfg, st, p, rp, cv, cm, fp, lim)
            guess, last_control, waiting_time = _pre_solve(cfg, st2, scen)
            return pr, scen, st2, guess, last_control, waiting_time

        pr, scen, st2, guess, lc, wt = jax.vmap(pre)(
            state, plan, robot_pose, current_vel, costmap, footprint, limits)
        res = solver_batch(guess, scen)

        def post(pr, scen, st2, dt, res, lc, wt):
            out = _post_solve(cfg, st2, scen, dt, res, lc, wt,
                              fp_cost=pr.footprint_cost)
            return _tick_post(pr, st2, out)

        return jax.vmap(post)(pr, scen, st2, delta_t, res, lc, wt)

    return step


class MpcEngine:
    """Convenience wrapper: jitted single-robot and batched steps.

    >>> eng = MpcEngine(cfg)
    >>> state = eng.init_state()
    >>> out = eng.step(state, plan, robot_pose, vel, costmap, footprint, dt)
    """

    def __init__(self, cfg: MpcConfig, parity: bool = True):
        self.cfg = cfg
        self.parity = parity

        # Batched full tick with lockstep-tail compaction (identical per-lane
        # math to vmap(controller_step); see make_batched_controller_step).
        self._batch_step = jax.jit(make_batched_controller_step(cfg, parity))
        # The single-robot path routes through the batch-1 vmapped executable:
        # identical math. It was introduced for a compile-time pathology of
        # the unbatched scalar program on the engine's first backend; whether
        # a GPU still needs it is an open ROADMAP item.
        def _step1(*args):
            out = self._batch_step(*jax.tree.map(lambda x: x[None], args))
            return jax.tree.map(lambda x: x[0], out)

        self._step = _step1

    def init_state(self) -> ControlState:
        return init_state(self.cfg)

    def init_batch_state(self, batch: int) -> ControlState:
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,) + x.shape), init_state(self.cfg)
        )

    def step(self, state, plan, robot_pose, current_vel, costmap, footprint,
             delta_t, limits=None):
        return self._step(state, plan, robot_pose, current_vel, costmap, footprint,
                          jnp.asarray(delta_t, jnp.float32), limits)

    def batch_step(self, state, plan, robot_pose, current_vel, costmap, footprint,
                   delta_t, limits=None):
        return self._batch_step(state, plan, robot_pose, current_vel, costmap,
                                footprint, delta_t, limits)
