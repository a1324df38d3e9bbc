"""Two-process deployment demo: the optimization server + a plugin-side client.

Mirrors the reference deployment shape — the C++ plugin blocking on the
`optimizer` ROS service per tick (NeoMpcPlanner.cpp:248-250) with the Python
server solving (mpc_optimization_server.py:349-403) — over this framework's
newline-JSON TCP transport. The "robot" here is the same omni kinematic model
the controller assumes; the client integrates the returned command.

  python examples/serving_demo.py      # the server uses the default device
  JAX_PLATFORMS=cpu python examples/serving_demo.py   # CPU run

Only the server child touches a device; this parent process only speaks
the socket protocol.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

import numpy as np


def main() -> None:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = 7191
    env = dict(os.environ, PYTHONPATH=repo)
    server = subprocess.Popen(
        [sys.executable, "-c",
         "from neo_mpc_planner2_tpu.cli import server_main; "
         f"server_main(['--port', '{port}'])"],
        env=env)
    try:
        from neo_mpc_planner2_tpu.serving import OptimizerClient

        cli = OptimizerClient(port=port, wait_timeout=60.0)
        print("connected:", cli.call({"op": "ping"}))

        # Server-side context: empty local map + MPO-700-ish footprint.
        cli.call({"op": "configure", "params": {
            "max_vel_x": 0.5, "min_vel_x": -0.5, "max_vel_trans": 0.5,
            # The reference's SAMPLE weights (README.md:27-86). The raw
            # declared defaults are degenerate: with current_vel = 0 the
            # unsquared w_control*||u|| kink outweighs the translation
            # gradient and standing still is a true local optimum — scipy
            # SLSQP (the oracle) returns all-zero there too.
            "w_trans": 0.82, "w_orient": 0.5, "w_control": 0.05,
            "w_terminal": 0.05, "w_costmap": 0.05,
            "prediction_horizon": 0.8, "control_steps": 3,
            # This demo drives the server RAW (carrot = goal, no plugin
            # layer shrinking the lookahead near the goal), so give the
            # accel clamp enough authority to decelerate in time.
            "acc_x_limit": 2.0, "acc_y_limit": 2.0, "acc_theta_limit": 2.0,
            "opt_tolerance": 1e-3}})
        cli.call({"op": "set_costmap",
                  "data": np.zeros((64, 64)).tolist(),
                  "origin": [-1.6, -1.6], "resolution": 0.05})
        cli.call({"op": "set_footprint",
                  "points": [[0.365, 0.275], [-0.365, 0.275],
                             [-0.365, -0.275], [0.365, -0.275]]})

        # Drive toward a goal well inside the static 3.2 m map window
        # (the 0.8 s rollout from near the edge would read out-of-window
        # cells as lethal and latch the predicted-collision stop).
        goal = [0.8, 0.3, 0.0]
        pose = [0.0, 0.0, 0.0]
        vel = [0.0, 0.0, 0.0]
        dt = 1.0 / 30.0
        for tick in range(200):
            carrot = [goal[0] - pose[0], goal[1] - pose[1], goal[2] - pose[2]]
            # Rotate the carrot into the base frame.
            c, s = math.cos(-pose[2]), math.sin(-pose[2])
            carrot = [carrot[0] * c - carrot[1] * s,
                      carrot[0] * s + carrot[1] * c, carrot[2]]
            rsp = cli.call({"op": "optimizer", "current_pose": pose,
                            "carrot_pose": carrot, "goal_pose": goal,
                            "current_vel": vel, "control_interval": dt,
                            "delta_t": dt})
            vel = rsp["output_vel"]
            # Plant: one step of the same omni model.
            pose = [pose[0] + dt * (vel[0] * math.cos(pose[2])
                                    - vel[1] * math.sin(pose[2])),
                    pose[1] + dt * (vel[0] * math.sin(pose[2])
                                    + vel[1] * math.cos(pose[2])),
                    pose[2] + dt * vel[2]]
            dist = math.hypot(goal[0] - pose[0], goal[1] - pose[1])
            if tick % 20 == 0:
                print(f"tick {tick:3d}  dist {dist:.3f} m  "
                      f"cmd [{vel[0]:+.3f} {vel[1]:+.3f} {vel[2]:+.3f}]")
            if dist < 0.08:
                print(f"reached goal at tick {tick} (dist {dist:.3f} m)")
                break

        # Fleet serving: the same server drives N robots per request as one
        # batched device dispatch (op: optimizer_batch), each robot keeping
        # its own warm-start lane. The reference needs a server process per
        # robot; here three robots cost one solve round-trip per tick.
        print("\nfleet serving (3 robots, one request per tick):")
        fleet = [{"pose": [0.0, 0.1 * i, 0.0], "vel": [0.0, 0.0, 0.0],
                  "goal": [0.8, 0.3 - 0.2 * i, 0.0]} for i in range(3)]
        for tick in range(120):
            robots = []
            for r in fleet:
                dxy = [r["goal"][0] - r["pose"][0], r["goal"][1] - r["pose"][1],
                       r["goal"][2] - r["pose"][2]]
                c, s = math.cos(-r["pose"][2]), math.sin(-r["pose"][2])
                robots.append({
                    "current_pose": r["pose"],
                    "carrot_pose": [dxy[0] * c - dxy[1] * s,
                                    dxy[0] * s + dxy[1] * c, dxy[2]],
                    "goal_pose": r["goal"], "current_vel": r["vel"],
                    "control_interval": dt})
            rsp = cli.call({"op": "optimizer_batch", "robots": robots,
                            "delta_t": dt})
            dists = []
            for r, res in zip(fleet, rsp["results"]):
                v = res["output_vel"]
                r["vel"] = v
                p = r["pose"]
                r["pose"] = [p[0] + dt * (v[0] * math.cos(p[2])
                                          - v[1] * math.sin(p[2])),
                             p[1] + dt * (v[0] * math.sin(p[2])
                                          + v[1] * math.cos(p[2])),
                             p[2] + dt * v[2]]
                dists.append(math.hypot(r["goal"][0] - r["pose"][0],
                                        r["goal"][1] - r["pose"][1]))
            if tick % 20 == 0:
                print(f"tick {tick:3d}  dists " +
                      " ".join(f"{d:.3f}" for d in dists))
            if max(dists) < 0.08:
                print(f"all 3 robots reached their goals at tick {tick}")
                break
        cli.close()
    finally:
        server.terminate()
        server.wait(timeout=10)


if __name__ == "__main__":
    main()
