"""Single-robot controller facade — the nav2_core::Controller API surface.

The reference's deployment unit is the `NeoMpcPlanner` plugin, whose public
interface is the nav2_core::Controller virtual API (include/NeoMpcPlanner.h:
72-122): configure / activate / deactivate / cleanup / setPlan /
computeVelocityCommands / setSpeedLimit. This class offers the same lifecycle
and per-tick API over the device engine so a reference user can port call sites
1:1 — without ROS, and with the whole tick running as one device step instead
of the plugin→DDS→scipy round trip.

The native C++ front-end (native/) remains available for hosts that want the
geometry in C++; this facade uses the fused device path.
"""

from __future__ import annotations

import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .config import MpcConfig, config_from_ros_params, default_config
from .engine import MpcEngine, StepResult
from .ops.costmap import Costmap
from .ops.footprint import Footprint
from .ops.pursuit import Plan
from .utils.viz import (carrot_msg, local_plan_msg, plan_msg,
                        predicted_footprint_msg)

__all__ = ["NeoMpcController", "ControllerException"]


class ControllerException(RuntimeError):
    """Raised like nav2_core::ControllerException (cpp:70, :76, :131, :235)."""


class NeoMpcController:
    """Lifecycle + tick API mirroring the reference plugin.

    >>> ctrl = NeoMpcController()
    >>> ctrl.configure(params, costmap, footprint)
    >>> ctrl.activate()
    >>> ctrl.set_plan(plan_xyyaw)
    >>> cmd = ctrl.compute_velocity_commands(pose, velocity)
    """

    def __init__(self) -> None:
        self.cfg: Optional[MpcConfig] = None
        self._engine: Optional[MpcEngine] = None
        self._state = None
        self._plan: Optional[Plan] = None
        self._costmap: Optional[Costmap] = None
        self._footprint: Optional[Footprint] = None
        self._active = False
        # 0.0 baseline is REFERENCE PARITY (py:138): the first tick's
        # wall-clock delta_t is epoch-sized, so a collision latched on the
        # very first tick has its 3 s stuck-wait instantly expired — the
        # reference does exactly this. Don't "fix" by stamping at configure;
        # pass delta_t explicitly for deterministic behavior.
        self._last_time = 0.0
        self._native = None
        self._limits = None
        self.last_result: Optional[StepResult] = None
        self._last_pose = None       # robot pose of the last tick (map frame)
        self._last_window = None     # (begin, end) plan indices of the last tick

    # ---- lifecycle (h:72-90) ----
    def configure(self, params=None, costmap: Optional[Costmap] = None,
                  footprint: Optional[Footprint] = None,
                  parity: bool = True, native_geometry: bool = False) -> None:
        """configure() equivalent (cpp:290-334). params: MpcConfig or a dict
        of reference ROS parameter names.

        native_geometry=True routes the pursuit geometry (plan pruning, carrot
        selection, hysteresis, lethal gate) through the C++ host library
        (native/, the reference's Layer A in native code) and only the solve
        runs on device — the two-layer deployment shape with no TCP hop.
        Requires scripts/build_native.sh to have been run.
        """
        if isinstance(params, MpcConfig):
            self.cfg = params
        elif params is not None:
            self.cfg = config_from_ros_params(params)
        else:
            self.cfg = default_config()
        if costmap is not None:
            self._costmap = costmap
        if footprint is not None:
            self._footprint = footprint
        self._parity = parity
        self._native_geometry = native_geometry
        self._limits = None
        self._ensure_footprint_sampling()
        self._build_engine()
        self._state = self._engine.init_state()
        # Speed limits scale from the configured maxima (cpp setSpeedLimit
        # doc: "percentage from maximum robot speed"), not compounding.
        self._base_cfg = self.cfg

    def _build_engine(self) -> None:
        parity = self._parity
        self._engine = MpcEngine(self.cfg, parity=parity)
        self._native = None
        if self._native_geometry:
            from .native.host import NativeHost

            self._native = NativeHost(
                lookahead_dist_min=self.cfg.lookahead_dist_min,
                lookahead_dist_max=self.cfg.lookahead_dist_max,
                lookahead_dist_close_to_goal=self.cfg.lookahead_dist_close_to_goal,
                controller_frequency=self.cfg.controller_frequency,
            )
            from .ops.objective import make_objective
            from .sqp import make_sqp_solver
            from .engine import solve_step
            import jax

            solver = make_sqp_solver(self.cfg, make_objective(self.cfg, parity=parity))
            cfg = self.cfg

            def _solve(state, scen, dt):
                return solve_step(cfg, state, scen, dt, solver=solver)

            self._native_solve = jax.jit(_solve)

    def _ensure_footprint_sampling(self) -> None:
        """Guarantee the uniform edge sampling cannot skip costmap cells: bump
        footprint_edge_samples to ceil(max_edge/resolution)+2 when the
        configured count would space samples wider than a cell (ADVICE
        round-1). Exact-traversal mode needs no count at all."""
        if (self.cfg is None or self.cfg.footprint_exact
                or self._costmap is None or self._footprint is None):
            return
        from .ops.footprint import required_edge_samples

        nv = int(self._footprint.n_valid)
        need = required_edge_samples(
            np.asarray(self._footprint.vertices)[:nv],
            float(self._costmap.resolution))
        if need > self.cfg.footprint_edge_samples:
            # Auto-corrected, safe by construction: log (not warn) so routine
            # configure() calls with the default count don't spam warnings
            # (round-2 advice); the count is visible on self.cfg either way.
            import logging

            logging.getLogger(__name__).info(
                "footprint_edge_samples=%d spaces samples wider than the "
                "%g m map resolution for this footprint; raising to %d",
                self.cfg.footprint_edge_samples,
                float(self._costmap.resolution), need)
            self.cfg = self.cfg.replace(footprint_edge_samples=need)
            if self._engine is not None:
                self._build_engine()

    def activate(self) -> None:
        if self.cfg is None:
            raise ControllerException("configure() before activate()")
        self._active = True

    def deactivate(self) -> None:
        self._active = False

    def cleanup(self) -> None:
        self._engine = None
        self._state = None
        self._plan = None

    # ---- inputs ----
    def set_costmap(self, costmap: Costmap) -> None:
        self._costmap = costmap
        self._ensure_footprint_sampling()

    def set_footprint(self, footprint: Footprint) -> None:
        self._footprint = footprint
        self._ensure_footprint_sampling()

    def set_plan(self, plan) -> None:
        """setPlan (cpp:274-281): stores the plan; goal-change handling (the
        slow-down latch and warm-start reset) happens in-engine via the
        old_goal comparison, like the server side of the reference."""
        if self.cfg is None:
            raise ControllerException("configure() first")
        if not isinstance(plan, Plan):
            plan = Plan.create(np.asarray(plan, np.float32),
                               max_points=self.cfg.max_plan_points)
        if int(plan.n_valid) == 0:
            raise ControllerException("Received plan with zero length")  # cpp:70
        # Goal change latches slow-down (cpp:277-279) so the next tick uses
        # the conservative lookahead until the hysteresis clears it.
        new_goal = np.asarray(plan.goal())
        goal_changed = (self._plan is None or
                        not np.array_equal(np.asarray(self._plan.goal()),
                                           new_goal))
        self._plan = plan
        # The last tick's window indices refer to the OLD plan — slicing the
        # new one with them would publish garbage (round-3 review finding).
        self._last_window = None
        # New plan: reset the consumed-prefix index (the reference keeps a
        # fresh copy of the plan, cpp:276).
        self._state = self._state.replace(
            plan_start=jnp.int32(0),
            slow_down=jnp.asarray(bool(goal_changed) or bool(self._state.slow_down)),
        )
        if self._native is not None:
            nv = int(plan.n_valid)
            self._native.set_plan(np.asarray(plan.poses)[:nv])

    def set_speed_limit(self, speed_limit: float, percentage: bool) -> None:
        """setSpeedLimit (h:122, cpp:283-288). The reference leaves this
        EMPTY — a silent no-op. Kept functional here (scales max_vel_trans /
        box bounds) because a no-op speed limiter on a real robot is a safety
        bug, not a quirk worth preserving.

        Retrace-free: the scaled bounds ride a runtime Limits pytree into the
        already-compiled engine step (the first limited tick traces the
        with-limits executable once; every later change reuses it)."""
        if self.cfg is None:
            raise ControllerException("configure() first")
        from .ops.objective import Limits

        base = self._base_cfg
        scale = (speed_limit / 100.0 if percentage
                 else speed_limit / base.max_vel_trans)
        scale = float(np.clip(scale, 1e-3, 1.0))
        # cfg mirrors the effective bounds for introspection; the engine is
        # NOT rebuilt — the limits pytree carries the change. Scale the
        # velocity fields from BASE (so repeated speed-limit calls don't
        # compound) but apply them onto the CURRENT cfg: replacing cfg
        # wholesale from base silently reverted later auto-corrections
        # (e.g. the footprint_edge_samples bump from set_costmap), which
        # the next set_costmap would then re-apply with a full engine
        # rebuild mid-mission (round-5 review).
        self.cfg = self.cfg.replace(
            max_vel_trans=base.max_vel_trans * scale,
            max_vel_x=base.max_vel_x * scale, min_vel_x=base.min_vel_x * scale,
            max_vel_y=base.max_vel_y * scale, min_vel_y=base.min_vel_y * scale,
        )
        self._limits = Limits.from_config(self.cfg)

    # ---- the tick (cpp:202-254) ----
    def compute_velocity_commands(self, pose, velocity,
                                  delta_t: Optional[float] = None) -> np.ndarray:
        """One control tick. Raises ControllerException on the lethal gate
        (cpp:234-236 'MPC detected collision!') and on missing inputs."""
        if not self._active:
            raise ControllerException("controller not activated")
        if self._plan is None:
            raise ControllerException("Received plan with zero length")
        if self._costmap is None or self._footprint is None:
            raise ControllerException("costmap/footprint not set")

        if delta_t is None:
            now = time.time()
            delta_t = now - self._last_time  # py:369-371 semantics
            self._last_time = now

        self._last_pose = np.asarray(pose, float)
        if self._native is not None:
            return self._tick_native(pose, velocity, float(delta_t))

        out = self._engine.step(
            self._state, self._plan,
            jnp.asarray(pose, jnp.float32), jnp.asarray(velocity, jnp.float32),
            self._costmap, self._footprint, float(delta_t),
            limits=self._limits,
        )
        self._state = out.state
        self.last_result = out
        # Device arrays, NOT fetched here: int() would add two scalar
        # device->host round trips (each a sync with the device) to every
        # tick for debug-only data; transformed_plan() converts lazily.
        self._last_window = (out.plan_window_begin, out.plan_window_end)
        if bool(out.plan_empty):
            raise ControllerException("Resulting plan has 0 poses in it.")  # cpp:131
        if bool(out.lethal):
            raise ControllerException("MPC detected collision!")  # cpp:235
        return np.asarray(out.cmd_vel)

    def _tick_native(self, pose, velocity, delta_t: float) -> np.ndarray:
        """C++ geometry + device solve (the reference's two-layer split,
        minus the transport)."""
        from .native.host import (NMP_ERR_EMPTY_PLAN, NMP_ERR_LETHAL,
                                  NMP_ERR_NO_WINDOW, NMP_OK)
        from .ops.objective import Scenario

        nv = int(self._footprint.n_valid)
        fp_np = np.asarray(self._footprint.vertices)[:nv]
        status, req = self._native.tick(
            np.asarray(pose, float), np.asarray(velocity, float),
            np.asarray(self._costmap.data), np.asarray(self._costmap.origin),
            float(self._costmap.resolution), fp_np)
        if status == NMP_ERR_EMPTY_PLAN:
            raise ControllerException("Received plan with zero length")
        if status == NMP_ERR_NO_WINDOW:
            raise ControllerException("Resulting plan has 0 poses in it.")
        if status == NMP_ERR_LETHAL:
            raise ControllerException("MPC detected collision!")
        assert status == NMP_OK, status

        scen = Scenario.create(
            current_pose=req.current_pose, carrot_pose=req.carrot_pose,
            goal_pose=req.goal_pose, current_vel=req.current_vel,
            footprint=self._footprint, costmap=self._costmap,
            switch_opt=req.switch_opt, control_interval=req.control_interval,
            limits=self._limits)
        out = self._native_solve(self._state, scen, jnp.float32(delta_t))
        self._state = out.state
        self.last_result = out
        self._last_window = (req.window_begin, req.window_end)
        return np.asarray(out.cmd_vel)

    # ---- debug artifacts (A6/B7 parity) ----
    def transformed_plan(self) -> np.ndarray:
        """The last tick's transformed-plan window in the base frame — the
        poses the reference publishes as `received_global_plan` every tick
        (NeoMpcPlanner.cpp:109-128). (K, 3) x/y/yaw; empty (0, 3) before the
        first tick."""
        if (self._last_window is None or self._last_pose is None
                or self._plan is None):
            return np.zeros((0, 3))
        b, e = (int(self._last_window[0]), int(self._last_window[1]))
        poses = np.asarray(self._plan.poses)[b:e]
        r = self._last_pose
        c, s = np.cos(r[2]), np.sin(r[2])
        dx, dy = poses[:, 0] - r[0], poses[:, 1] - r[1]
        return np.stack(
            [dx * c + dy * s, -dx * s + dy * c, poses[:, 2] - r[2]], axis=-1)

    def debug_msgs(self) -> dict:
        if self.last_result is None:
            return {}
        msgs = {
            "lookahead_point": carrot_msg(np.asarray(self.last_result.carrot_pose)),
            "local_plan": local_plan_msg(np.asarray(self.last_result.local_plan)),
        }
        window = self.transformed_plan()
        msgs["received_global_plan"] = plan_msg(window, len(window))
        if self._footprint is not None:
            nv = int(self._footprint.n_valid)
            msgs["predicted_footprint"] = predicted_footprint_msg(
                np.asarray(self._footprint.vertices)[:nv],
                np.asarray(self.last_result.local_plan)[-1])
        return msgs
