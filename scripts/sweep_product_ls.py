"""A/B the PRODUCT-mode line-search structure at the bench operating point.

The shipped product_config uses the fully-parallel Armijo wave
(`parallel_line_search`): all `max_backtracks` candidates evaluated in one
widened merit eval every SQP iteration, because the smooth objective's
merit eval is expensive. But the parallel branch pays the full 7-candidate eval even on
iterations where the FIRST candidate accepts (warm Newton-ish steps) and
even for done lanes. The chunked wave (`solver_ls_wave=K`) evaluates K
candidates per lockstep trip with a done-lane short-circuit and stops as
soon as every lane accepts — same first-accepted-alpha selection, so
commands match the parallel branch up to fusion-order float drift.

This sweep measures product-SQP closed-loop throughput for:
  parallel (shipped), wave K in {2, 3, 4}, sequential (K=1)
at the exact bench.py product operating point (fleet preset + bench weights,
quirks off, hoisted patch sampler), and reports each variant's command
divergence from the shipped parallel branch on the final tick.

Run on the GPU (single process):  python scripts/sweep_product_ls.py
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_product_cfg(control_steps: int = 3):
    """The bench.py product-SQP pass config, minus the line-search knobs."""
    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.ops.costmap import (
        required_product_patch_halfwidth)

    cfg = mpc.fleet_config().replace(
        prediction_horizon=0.8, control_steps=control_steps,
        opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        acc_x_limit=2.5, acc_y_limit=2.5, acc_theta_limit=3.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
        solver_ls_quad_interp=False,
        solver_patch_exact_picks=False,
    )
    cfg = cfg.replace(compat=dc.replace(
        cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
        lethal_1000x=False, unsquared_control_cost=False,
        no_angle_wrap=False))
    return cfg.replace(solver_costmap_patch=(
        required_product_patch_halfwidth(cfg, 0.05, 0.46)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="parallel,wave2,wave3,wave4")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate
    from neo_mpc_planner2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sync = jax.block_until_ready

    base = bench_product_cfg()
    sb = make_scenario_batch(base, args.batch, seed=0,
                             map_size=args.map_size, plan_points=64,
                             maps_on_device=True)

    def variant_cfg(name):
        if name == "parallel":
            return base.replace(parallel_line_search=True, solver_ls_wave=1)
        if name == "seq":
            return base.replace(parallel_line_search=False, solver_ls_wave=1)
        if name.startswith("wave"):
            return base.replace(parallel_line_search=False,
                                solver_ls_wave=int(name[4:]))
        raise ValueError(name)

    results = {}
    ref_cmds = None
    for name in args.variants.split(","):
        cfg = variant_cfg(name)
        sim = jax.jit(
            lambda b, st, po, ve, t, _cfg=cfg: batch_simulate(
                _cfg, b, t, parity=False, init=(st, po, ve)),
            static_argnums=4)
        from neo_mpc_planner2_tpu.engine import MpcEngine
        eng = MpcEngine(cfg)
        st0 = eng.init_batch_state(args.batch)
        run = sim(sb, st0, sb.robot_pose, sb.current_vel, args.ticks)
        sync(run.cmds)                       # compile + warm
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run = sim(sb, st0, sb.robot_pose, sb.current_vel, args.ticks)
            sync(run.cmds)
            best = min(best, time.perf_counter() - t0)
        sps = args.batch * args.ticks / best
        iters = float(jnp.mean(jnp.asarray(run.solver_iters, jnp.float32)))
        last = np.asarray(jax.device_get(run.cmds[:, -1]))
        if name == "parallel":
            ref_cmds = last
        diff = (float(np.abs(last - ref_cmds).max())
                if ref_cmds is not None else None)
        results[name] = {"solves_per_sec": round(sps, 1),
                         "s_per_run": round(best, 3),
                         "mean_iters": round(iters, 2),
                         "cmd_diff_max_vs_parallel": diff}
        print(f"[{name}] {sps:,.0f} solves/s  ({best:.3f} s/run, "
              f"mean iters {iters:.2f}, diff vs parallel {diff})",
              flush=True)

    print(json.dumps({"batch": args.batch, "ticks": args.ticks,
                      "map_size": args.map_size, "variants": results}))


if __name__ == "__main__":
    main()
