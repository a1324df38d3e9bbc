"""Configuration for the batched MPC engine.

Mirrors every ROS parameter of the reference so reference configs port 1:1:

- the 22 optimization-server parameters declared at
  /root/reference/neo_mpc_planner2/mpc_optimization_server.py:49-75
- the 3 plugin lookahead parameters + controller_frequency declared at
  /root/reference/src/NeoMpcPlanner.cpp:311-323

The config is a frozen dataclass registered as a *static* pytree leaf-free node so
that it can close over jitted functions without retracing on value identity
(hashable, compared by value). Weight *sweeps* are expressed by batching weight
arrays through `WeightBatch` instead (see ops/objective.py), so a single compiled
executable serves a whole weight grid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

__all__ = ["CompatConfig", "MpcConfig", "default_config", "fleet_config",
           "config_from_ros_params"]


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing reference quirks (SURVEY.md §2.3) for oracle parity.

    Every flag defaults to the *reference-faithful* behaviour so that parity tests
    against the scipy SLSQP oracle pass bit-tolerantly; flip them off for the
    "product" behaviour (what the reference evidently *meant* to do).
    """

    # mpc_optimization_server.py:213 — current-pose yaw computed with the GOAL
    # pose's quaternion w instead of the current pose's own w.
    buggy_odom_yaw: bool = True

    # mpc_optimization_server.py:227,238-244 — `update_footprint.points` aliases
    # `self.footprint.points`, and each vertex is restored in place, so the
    # footprint cost term is evaluated on the UNTRANSFORMED current footprint
    # (a per-solve constant), not the predicted one.
    footprint_alias_noop: bool = True

    # mpc_optimization_server.py:257-260 — if the sampled point cost is exactly
    # 1.0 the squared cost is scaled by a hardcoded 1000 instead of w_costmap.
    lethal_1000x: bool = True

    # mpc_optimization_server.py:253-254 — control cost multiplies the norm
    # (NOT norm²) of the velocity delta. Off => the conventional smooth
    # squared-norm term (and the prox solver treats it in the gradient path).
    unsquared_control_cost: bool = True

    # mpc_optimization_server.py:251,267 — orientation errors are raw
    # differences with no wrap to [-pi, pi].
    no_angle_wrap: bool = True

    # mpc_optimization_server.py:380 — the stuck-wait THRESHOLD is the
    # hardcoded literal 3.0 s; the declared `waiting_time` parameter (py:70,
    # README.md:77) is hijacked as the elapsed-time accumulator instead
    # (§2.3.6), so the parameter never takes effect. Off => cfg.waiting_time
    # is honored as the threshold (what the parameter doc says it does).
    hardcoded_stuck_wait: bool = True


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """All tunables of the engine. Field names match the reference ROS params."""

    # --- acceleration limits (py:49-51; README.md:53-55) ---
    acc_x_limit: float = 0.5
    acc_y_limit: float = 0.5
    acc_theta_limit: float = 0.5

    # --- velocity bounds (py:53-61) ---
    min_vel_x: float = -0.5
    min_vel_y: float = -0.5
    min_vel_trans: float = 0.5  # declared but unused by the reference (py:55, §2.3.12)
    min_vel_theta: float = -0.5
    max_vel_x: float = 0.5
    max_vel_y: float = 0.5
    max_vel_trans: float = 0.5
    max_vel_theta: float = 0.5

    # --- cost weights (py:63-68) ---
    w_trans: float = 0.5
    w_orient: float = 0.5
    w_control: float = 0.5
    w_terminal: float = 0.5
    w_costmap: float = 0.5
    w_footprint: float = 2000.0

    # --- control post-processing (py:70-72) ---
    waiting_time: float = 3.0  # stuck-wait threshold; reference hardcodes 3.0 (py:380)
    low_pass_gain: float = 0.5
    opt_tolerance: float = 1e-5

    # --- horizon (py:73-75) ---
    prediction_horizon: float = 0.5
    control_steps: int = 3

    # --- plugin params (cpp:311-323) ---
    lookahead_dist_min: float = 0.5
    lookahead_dist_max: float = 0.5
    lookahead_dist_close_to_goal: float = 0.5
    controller_frequency: float = 30.0

    # --- engine-only knobs (no reference equivalent) ---
    # Max outer SQP iterations (device solver). At fleet scale the batched
    # while-loop runs lockstep until the slowest lane finishes, so this cap is
    # the main worst-case-latency lever.
    solver_max_iters: int = 40
    # ADMM iterations for each SQP QP subproblem.
    qp_iters: int = 60
    # Evaluate all Armijo step candidates in one fused wave instead of a
    # lockstep sequential loop (identical alpha selection; see sqp.py).
    parallel_line_search: bool = False
    # Dykstra iterations for the box∩disk projection.
    projection_iters: int = 20
    # Footprint polygon is padded to this many vertices (static shape).
    max_footprint_vertices: int = 8
    # Samples per footprint edge for the line cost (static shape).
    footprint_edge_samples: int = 32
    # Transformed-plan window is padded to this many poses (static shape).
    max_plan_points: int = 128
    # Costmap sampling backend for the footprint boundary: "gather" (flat 1-D
    # gather) or "onehot" (one-hot matrix contractions, for backends without
    # a fast vector gather; which wins on a GPU is not measured yet).
    costmap_sampling: str = "gather"
    # Cell-exact footprint boundary traversal (Amanatides-Woo grid walk, the
    # device twin of the native host / nav2 LineIterator): no cell along an
    # edge can be skipped regardless of edge length, at the cost of a
    # sequential H+W-step scan per footprint evaluation. Off => uniform edge
    # sampling with `footprint_edge_samples` points (validate the count with
    # ops.footprint.required_edge_samples; the controller/serving front-ends
    # do this automatically).
    footprint_exact: bool = False
    # Solver-loop costmap patch half-width in CELLS (0 = off). When > 0, each
    # solve extracts a (2h+1)² window around the robot once and every
    # merit/objective costmap sample in the hot loop reads the patch instead
    # of the full map (bit-identical values; see ops.costmap.CostmapPatch).
    # MUST satisfy h >= required_patch_halfwidth(cfg, resolution) — validated
    # by the host-side entry points that see concrete resolutions.
    solver_costmap_patch: int = 0
    # Pick precision for the patch samplers' in-loop one-hot contractions
    # (ops.costmap.patch_cost_at_cells). True (default): Precision.HIGHEST —
    # picked values bit-identical to the full-map samplers on every backend.
    # False: the backend's default matmul precision — TF32 on an NVIDIA GPU,
    # so picked cost values round to 10 mantissa bits (≤2^-11 relative on
    # [0, 1] costs; CPU stays bit-exact either way). product_config ships
    # False (the smooth objective has no exact-equality semantics;
    # chip_smoke.py prints its goal capture at this setting); leave True
    # wherever the bit-identical patch guarantee is load-bearing (e.g.
    # parity-mode patch sampling).
    solver_patch_exact_picks: bool = True
    # Gather the solver's hot-loop costmap samples from a uint8 raw-scale
    # (0-255) companion buffer instead of the f32 map — 4x less random-read
    # footprint for the latency-bound merit-eval gather. Decode is u8/255.0,
    # the exact encode expression of Costmap.from_nav2_costmap, so costs are
    # BIT-IDENTICAL for any map whose values lie on the raw /255 grid (all
    # nav2-sourced maps); maps with off-grid float values quantize to the
    # nearest /255 step (<= 1/510 error) — hence opt-in. "auto" enables it
    # only for maps of >= 128² cells (ops.costmap.U8_AUTO_MIN_CELLS) — for
    # deployments that know their maps are nav2 raw-grid sourced.
    solver_costmap_u8: "bool | str" = False
    # Lockstep-tail compaction for the BATCHED solve paths (MpcEngine
    # .batch_step / batch_simulate): after `solver_compact_after` full-batch
    # SQP iterations, if at most ceil(B·solver_compact_frac) lanes are still
    # unconverged, gather them into a compact sub-batch and run the remaining
    # iterations only there (sqp.make_sqp_solver_batched). Identical per-lane
    # math — values equal to ~1e-6 (XLA fusion reassociation), iteration
    # counts exact; 0 disables. Applied only when the batch is at least
    # `solver_compact_min_batch` (below that the tail is cheaper than the
    # gather/scatter plumbing).
    # DEFAULT OFF (0): it lost to the plain lockstep at the default program
    # on the engine's first backend once the per-iteration cost fell; not
    # measured on a GPU. The knob remains for operating points with fatter
    # tails.
    solver_compact_after: int = 0
    solver_compact_frac: float = 0.0625
    solver_compact_min_batch: int = 256
    # Adaptive compaction (difficulty-aware lockstep): instead of compacting
    # at the fixed iteration solver_compact_after, run full-batch SQP
    # iterations only WHILE more than ceil(B·solver_compact_frac) lanes are
    # still alive, then gather the stragglers into the compact sub-batch and
    # finish only them. A warm fleet whose alive count collapses after 3
    # iterations stops paying full-batch trips at iteration 4 — easy lanes
    # stop funding the hard lanes' lockstep depth at the earliest possible
    # point, at ANY operating point (the fixed-k1 scheme auto-disables when
    # max_iters <= k1, e.g. the cap-8 bench point). Per-lane math identical;
    # XLA fusion may reassociate float ops (~1e-6, like the fixed scheme).
    # It lost to the plain lockstep while on the engine's first backend (the
    # warm alive-set did not collapse below the compact size early enough
    # to amortize the batch-level restructuring); not measured on a GPU.
    # Kept available for operating points with fatter iteration tails;
    # default off. Ignored
    # (plain path) when solver_costmap_patch > 0: the restructured body
    # would re-trace the per-solve patch extraction every batch-level trip
    # (sqp.make_sqp_solver_batched).
    solver_compact_adaptive: bool = False
    # Armijo line-search wave width: candidates 2^-j evaluated per merit
    # evaluation. >1 amortizes the batched costmap gather's fixed overhead
    # (whatever the number of points it fetches) over K
    # halving candidates; selected alphas are bit-identical to sequential
    # backtracking (first accepted candidate in halving order). 1 = classic
    # sequential halving.
    solver_ls_wave: int = 1
    # Armijo backtracking schedule: candidate j is ls_backtrack^j, up to
    # max_backtracks candidates. Under lockstep vmap every lane pays the
    # slowest ALIVE lane's trip count, and a lane that rejects every candidate
    # (the nonsmooth control kink) burns the full budget for the whole batch —
    # so the schedule's depth/steepness is a fleet-throughput lever. 0.5 is
    # classic halving; steeper (e.g. 0.25) reaches small steps in half the
    # trips at coarser alpha granularity (changes which alpha is accepted =>
    # changed solutions; operating points that deviate from the defaults need
    # a fidelity study, like solver_max_iters=8).
    solver_ls_backtrack: float = 0.5
    solver_max_backtracks: int = 16
    # Two-phase schedule: after `solver_ls_coarse_after` rejected candidates
    # the factor switches to `solver_ls_coarse_factor` (0 = single-phase).
    # Rationale: almost every accepted alpha is one of the first few
    # candidates — keeping those on the fine 0.5 grid preserves fidelity —
    # while the DEPTH of the schedule is set by reject-everything episodes at
    # the nonsmooth control kink, which burn lockstep trips for the whole
    # batch; coarsening only the deep tail cuts those trips at almost no
    # solution drift (cmd-diff p99 0.0039 m/s vs the single-phase program).
    solver_ls_coarse_after: int = 0
    solver_ls_coarse_factor: float = 0.25
    # Per-lane warm-started initial step: the line search starts each outer
    # iteration at min(1, 2·alpha_accepted_prev) instead of 1. A lane parked
    # at a small alpha (the control-kink neighborhood) re-finds it in ~1 trip
    # instead of re-descending the whole schedule — but a lane whose full
    # step WOULD have been accepted takes the smaller warm step instead
    # (alpha recovers at 2x per iteration), so solutions change: operating
    # points enabling this need the sweep_ls fidelity gate. Off by default.
    solver_ls_warm_alpha: bool = False
    # Quadratic-interpolation backtracking (an eval-count lever): on a
    # rejected candidate the next alpha minimizes the 1-D quadratic through
    # (phi(0), dphi(0), phi(alpha)) instead of multiplying by the fixed
    # schedule factor, safeguarded to [0.1·alpha, 0.5·alpha] (Nocedal&Wright
    # §3.5). Deep-backtrack episodes (the reject-everything control-kink
    # lanes that set the lockstep trip count) can land in fewer trips, but
    # accepted alphas leave the fixed grid, so solutions change: operating
    # points enabling this need the sweep_ls fidelity gate (cmd-diff p99
    # <= 0.004, lanes<0.01 >= 0.9). Off by default. Its speed gain depends
    # on the batch (more lanes, more interpolation arithmetic per trip):
    # where it turns into a loss on a GPU is not measured yet (PERF.md).
    solver_ls_quad_interp: bool = False
    # Compatibility quirks toggle.
    compat: CompatConfig = dataclasses.field(default_factory=CompatConfig)

    # ------------------------------------------------------------------
    @property
    def dt(self) -> float:
        """Integration interval (py:137)."""
        return self.prediction_horizon / self.control_steps

    @property
    def control_interval(self) -> float:
        """Service-request control interval (cpp:246)."""
        return 1.0 / self.controller_frequency

    @property
    def footprint_mode(self) -> str:
        """Sampling mode string for ops.footprint.footprint_cost."""
        return "exact" if self.footprint_exact else self.costmap_sampling

    def replace(self, **kw: Any) -> "MpcConfig":
        return dataclasses.replace(self, **kw)


# ROS parameter name -> MpcConfig field for names that differ.
_ROS_ALIASES = {
    "control_steps": "control_steps",
    "w_costmap": "w_costmap",
    "w_footprint": "w_footprint",
}


def default_config() -> MpcConfig:
    """Library default: the reference's parameter defaults with FULL solver
    fidelity (max_iters=40, single-phase fine-grid Armijo). This is the
    bit-tolerant-SLSQP-parity operating point — the project's north-star
    contract (BASELINE.md) — and it is deliberately NOT the fastest one:
    the two-phase line-search schedule + iteration cap trade a
    command-fidelity cost of p99 0.0039 m/s vs this default program for
    fewer lockstep trips. Parity-by-default keeps
    every oracle/golden gate exact; deployments that want the fast
    point opt in explicitly via `fleet_config()`."""
    return MpcConfig()


def fleet_config() -> MpcConfig:
    """The fleet-throughput operating point — what bench.py and
    chip_smoke.py run.

    Differences from `default_config()`, each with its fidelity study:
    - solver_max_iters=8: warm lanes converge in <=4 iterations; capped
      lanes warm-start from the raw solution next tick exactly like the
      reference tolerates SLSQP failure (py:397-400). Command diff vs the
      cap-40 program: p99 0.0038 m/s, goal-distance distribution identical
      to 4 decimals.
    - two-phase Armijo (max_backtracks=7, coarse_after=2, factor 1/16):
      accepted alphas stay on the fine 0.5 grid; only reject-everything
      episodes at the nonsmooth control kink coarsen. p99 0.0039 m/s /
      91.5 % lanes within 0.01 of the single-phase program.
    - solver_costmap_u8="auto": uint8 gather source for >=128² maps
      (value-exact for nav2 raw-grid maps).
    - solver_ls_quad_interp=True: quadratic-interpolation backtracking,
      with tighter fidelity than the fixed schedule (cmd-diff p99 0.0021
      vs 0.0039, lanes<0.01 0.938 vs 0.917) — the interpolated alpha both
      accepts earlier and lands nearer the cap-40 solution. Its speed gain
      is batch-bounded (see the knob's field comment).
    (Adaptive lockstep compaction stays off: see solver_compact_adaptive.)
    The speed of each lever on a GPU is not measured yet (PERF.md).

    Single-solve commands remain within the fidelity gates above but are NOT
    bit-parity with scipy SLSQP — use default_config() for that contract.
    """
    return MpcConfig(
        solver_max_iters=8,
        solver_max_backtracks=7,
        solver_ls_coarse_after=2,
        solver_ls_coarse_factor=0.0625,
        solver_costmap_u8="auto",
        solver_ls_quad_interp=True,
    )


def product_config() -> MpcConfig:
    """The PRODUCT-mode operating point: every reference quirk off
    (smooth bilinear costmap term, true predicted footprint, wrapped angles)
    on the fleet solver preset, with ONE solver knob flipped — the line
    search runs as a single fused candidate WAVE (`parallel_line_search`)
    instead of sequential backtracking.

    Why the flip: the smooth objective's merit evaluation is expensive (a
    per-step predicted footprint — 4 edges x 16 boundary samples — plus
    bilinear point costs), so the sequential Armijo loop's ~7 lockstep
    trips per SQP iteration dominate the product solve. One wave evaluates
    all 7 candidates in a single widened eval and selects the SAME alpha
    sequential halving would (first accepted in schedule order). Parity
    mode keeps sequential + quad-interp: its hoisted-sampler merit eval is
    so cheap that a 7-wide wave costs more than the trips it saves.
    quad-interp is off here because it is mutually exclusive with the wave
    (and its fidelity study was parity-only). Neither choice has been
    re-measured on a GPU (PERF.md).

    Second lever: set `solver_costmap_patch` to hoist ONE
    patch extraction per solve — every bilinear point cost and footprint
    boundary sample then contracts over the (P, P) window instead of the
    full map (ops.costmap.ProductPatchSampler; values bit-identical inside
    the coverage guarantee at solver_patch_exact_picks=True — this preset
    trades to backend-precision picks, see the third lever below), so the
    product solve's cost becomes map-size-independent. The halfwidth is in
    CELLS and depends on resolution + footprint, so the preset cannot bake
    it; size it with

        from neo_mpc_planner2_tpu.ops.costmap import (
            required_product_patch_halfwidth)
        cfg = product_config()
        cfg = cfg.replace(solver_costmap_patch=
            required_product_patch_halfwidth(cfg, resolution,
                                             footprint_circumradius_m))

    (too small is conservative, not unsafe: out-of-patch reads are lethal).

    Third lever: `solver_patch_exact_picks=False` — the patch sampler's
    in-loop one-hot picks run at the backend's default matmul precision
    instead of Precision.HIGHEST. On an NVIDIA GPU that is TF32: picked
    cost values round to 10 mantissa bits (≤2^-11 relative); CPU stays
    bit-exact. Meant for the smooth objective, which has no exact-equality
    semantics; chip_smoke.py prints product-mode goal capture at this
    setting. The library default stays True (exact).

    Use with `parity=False` engines/sims:
        cfg = product_config()
        run = batch_simulate(cfg, batch, ticks, parity=False)
    """
    import dataclasses as _dc

    base = fleet_config()
    return base.replace(
        parallel_line_search=True,
        solver_ls_quad_interp=False,
        # Backend-default matmul precision for the patch sampler's in-loop
        # picks: TF32 on an NVIDIA GPU (≤2^-11 relative rounding of picked
        # costs) — meant for the smooth objective; CPU remains bit-exact.
        # Set True to restore device bit-identity with the full-map
        # samplers.
        solver_patch_exact_picks=False,
        compat=_dc.replace(
            base.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
            lethal_1000x=False, unsquared_control_cost=False,
            no_angle_wrap=False),
    )


def config_from_ros_params(params: Mapping[str, Any],
                           base: "MpcConfig | None" = None) -> MpcConfig:
    """Build a config from a flat dict using the reference's ROS parameter names.

    Accepts both the server params (mpc_optimization_server.py:49-75) and the
    plugin params (NeoMpcPlanner.cpp:311-323). Unknown keys are ignored so a
    full navigation.yaml section can be passed straight through.

    With `base`, only the named parameters are replaced and everything else is
    kept — the reference's cb_params semantics (py:405-439 updates only the
    parameters in the message); without it, unnamed parameters get defaults
    (initial declare_parameter semantics, py:49-75).
    """
    field_types = {f.name: f.type for f in dataclasses.fields(MpcConfig)}
    kw = {}
    for key, value in params.items():
        name = _ROS_ALIASES.get(key, key)
        if name in field_types and name != "compat":
            # ROS/yaml quirk: scientific notation without a dot ("1e-3")
            # parses as a *string* under YAML 1.1; the rclpy parameter loader
            # coerces it, so we do too (typed by the config field).
            t = str(field_types[name])
            if isinstance(value, str) and "float" in t:
                value = float(value)
            elif isinstance(value, str) and "int" in t:
                value = int(float(value))
            kw[name] = value
    if base is not None:
        return dataclasses.replace(base, **kw)
    return MpcConfig(**kw)
