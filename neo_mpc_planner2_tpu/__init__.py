"""neo_mpc_planner2_tpu — a batched MPC engine for omnidirectional robots.

Brand-new JAX/XLA/Pallas re-design of the capabilities of
neobotix/neo_mpc_planner2 (ROS 2 Nav2 pure-pursuit plugin + scipy-SLSQP
optimization server): one pure, batched, differentiable controller step,
vmap-able over thousands of scenarios on one GPU and shardable over the
cards of a host (a flat mesh: every card reaches every other over NVLink).
See SURVEY.md for the layer map and reference citations.
"""

from .config import (CompatConfig, MpcConfig, config_from_ros_params,
                     default_config, fleet_config, product_config)
from .controller import ControllerException, NeoMpcController
from .engine import ControlState, MpcEngine, StepResult, controller_step, init_state, solve_step
from .ops.costmap import Costmap, cost_at_world, cost_at_world_bilinear
from .ops.footprint import Footprint, footprint_cost, footprint_cost_at_pose, transform_footprint
from .ops.objective import Scenario, Weights, make_objective, objective_parity, objective_product
from .ops.pursuit import Plan, PursuitResult, pursuit_tick
from .ops.rollout import rollout
from .solver import SolveResult, make_solver, project_feasible, prox_fista
from .sqp import make_sqp_solver, sqp_solve

__version__ = "0.1.0"

__all__ = [
    "CompatConfig", "MpcConfig", "config_from_ros_params", "default_config",
    "fleet_config", "product_config",
    "ControllerException", "NeoMpcController",
    "ControlState", "MpcEngine", "StepResult", "controller_step", "init_state", "solve_step",
    "Costmap", "cost_at_world", "cost_at_world_bilinear",
    "Footprint", "footprint_cost", "footprint_cost_at_pose", "transform_footprint",
    "Scenario", "Weights", "make_objective", "objective_parity", "objective_product",
    "Plan", "PursuitResult", "pursuit_tick",
    "rollout",
    "SolveResult", "make_solver", "project_feasible", "prox_fista",
    "make_sqp_solver", "sqp_solve",
]
