"""Demo: an MPO-700 follows a curved plan through a cluttered map.

Runs the full controller (pursuit → SQP solve → safety post-processing) in a
closed loop and prints the trajectory; optionally renders an ASCII map.

    python examples/follow_path_demo.py            # CPU or GPU, auto
    JAX_PLATFORMS=cpu python examples/follow_path_demo.py
"""

import numpy as np
import jax.numpy as jnp

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.scenarios import mpo700_footprint
from neo_mpc_planner2_tpu.utils.se2_np import integrate_cmd_np


def main() -> None:
    cfg = mpc.config_from_ros_params({
        # README.md:51-84 sample values
        "acc_x_limit": 2.5, "acc_y_limit": 2.5, "acc_theta_limit": 3.0,
        "min_vel_x": -0.7, "min_vel_y": -0.7, "min_vel_theta": -0.7,
        "max_vel_x": 0.7, "max_vel_y": 0.7, "max_vel_trans": 0.7,
        "max_vel_theta": 0.7, "w_trans": 0.82, "w_orient": 0.5,
        "w_control": 0.05, "w_terminal": 0.05, "w_costmap": 0.05,
        "w_footprint": 0.0, "low_pass_gain": 0.5, "opt_tolerance": 1e-3,
        "prediction_horizon": 0.8, "control_steps": 3,
        "lookahead_dist_min": 0.4, "lookahead_dist_max": 0.4,
        "lookahead_dist_close_to_goal": 0.4, "controller_frequency": 30.0,
    })

    # Curved plan to (2.0, 1.0) with a soft obstacle beside the path.
    t = np.linspace(0, 1, 80)
    plan_xy = np.stack([2.0 * t, t**2, np.arctan2(np.gradient(t**2),
                                                  np.gradient(2.0 * t))], 1)
    yy, xx = np.meshgrid(np.arange(120) * 0.05 - 1.0,
                         np.arange(120) * 0.05 - 1.0, indexing="ij")
    grid = 0.9 * np.exp(-(((xx - 1.0) ** 2) + (yy - 0.15) ** 2) / 0.02)
    costmap = mpc.Costmap.create(grid, origin=(-1.0, -1.0), resolution=0.05)

    ctrl = mpc.NeoMpcController()
    ctrl.configure(cfg, costmap=costmap, footprint=mpo700_footprint())
    ctrl.activate()
    ctrl.set_plan(plan_xy)

    pose = np.zeros(3)
    vel = np.zeros(3)
    dt = 1.0 / 30.0
    print(f"{'tick':>4} {'x':>7} {'y':>7} {'yaw':>7}   {'vx':>6} {'vy':>6} {'wz':>6}")
    for i in range(400):
        cmd = ctrl.compute_velocity_commands(pose, vel, dt)
        pose = integrate_cmd_np(pose, cmd, dt)
        vel = cmd
        if i % 30 == 0:
            print(f"{i:4d} {pose[0]:7.3f} {pose[1]:7.3f} {pose[2]:7.3f}   "
                  f"{cmd[0]:6.3f} {cmd[1]:6.3f} {cmd[2]:6.3f}")
        if (np.linalg.norm(pose[:2] - plan_xy[-1, :2]) < 0.05
                and np.hypot(cmd[0], cmd[1]) < 0.05):
            print(f"\nreached goal at tick {i} "
                  f"(dist {np.linalg.norm(pose[:2] - plan_xy[-1, :2]):.3f} m)")
            break
    else:
        print("\ndid not settle within 400 ticks")

    msgs = ctrl.debug_msgs()
    print("last lookahead point:", msgs["lookahead_point"]["point"])


if __name__ == "__main__":
    main()
