"""Attribute the product-mode (prox-FISTA + smooth objective) quality drop at
map-128: goal capture fell about 3 points from map-64 to map-128, with a
larger median final distance and more iterations, and no decomposition or
blocked-lane classification said why.

Candidate causes, isolated one per pass (same quality suite recipe as
bench.py: seed 1, 0.7-1.1 m plans, cleared corridor, plan-centered window):

  A. map64          — the reference point.
  B. map128         — the drop to attribute.
  C. embed_lethal   — the map-64 WORLD CONTENT embedded in a 128² grid with
                      a LETHAL (1.0) ring. Out-of-window reads are lethal by
                      nav2 convention, and boundary bilinear interpolation
                      sees the same 1.0 neighbors — so sampling semantics are
                      IDENTICAL to pass A cell-for-cell while the solver
                      runs the 128² executable. B-vs-C isolates grid-size /
                      term-scale effects from content; C-vs-A should be ~0.
  D. map128_cap16   — pass B with the prox iteration budget doubled
                      (solver cap 8 -> 16). Recovers quality iff the cap is
                      the binding constraint (mean iters 3.5 at cap 8 says
                      some lanes hit it).

All passes also classify non-reachers via the safety latch (collision |
lethal at the final tick) — the product_unreached_blocked_frac the parity
pass has had since round 3 (bench.py quality pass).

Run on the GPU (default env, one process):
  python scripts/product_decompose.py --batch 4096 --ticks 20 \
      --quality-ticks 160
CPU smoke: JAX_PLATFORMS=cpu with small --batch.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--quality-ticks", type=int, default=160)
    ap.add_argument("--passes", default="map64,map128,embed_lethal,"
                                        "map128_cap16")
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp

    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.ops.objective import make_objective
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate
    from neo_mpc_planner2_tpu.solver import make_solver

    def sync(x):
        return np.asarray(jax.device_get(x[..., :1, 0]
                                         if x.ndim > 1 else x[:1]))

    # The bench product-pass config (bench.py): fleet preset + sample weights,
    # quirks off.
    cfg = mpc.fleet_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        costmap_sampling="onehot",
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )
    pcfg = cfg.replace(compat=dataclasses.replace(
        cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
        lethal_1000x=False, unsquared_control_cost=False,
        no_angle_wrap=False))

    def suite(map_size):
        return make_scenario_batch(pcfg, args.batch, seed=1,
                                   map_size=map_size, plan_points=64,
                                   plan_length_range=(0.7, 1.1),
                                   clear_corridor_m=0.55, center_on="plan",
                                   maps_on_device=True)

    def embed(sb, big=128, fill=1.0):
        """Embed each lane's (64²) map at the center of a (big²) grid filled
        with `fill`, shifting origins so WORLD content is unchanged."""
        small = sb.costmap.data.shape[-1]
        pad = (big - small) // 2
        data = jnp.full(sb.costmap.data.shape[:-2] + (big, big),
                        jnp.float32(fill))
        data = data.at[..., pad:pad + small, pad:pad + small].set(
            sb.costmap.data)
        res = sb.costmap.resolution
        origin = sb.costmap.origin - (pad * res)[..., None]
        cm = mpc.Costmap(data=data, origin=origin, resolution=res)
        return sb._replace(costmap=cm)

    def run_pass(name, sb, solver_cap=None):
        psolver = jax.vmap(make_solver(pcfg, make_objective(pcfg,
                                                            parity=False),
                                       max_iters=solver_cap))
        simp = jax.jit(
            lambda b, st, po, ve, t: batch_simulate(
                pcfg, b, t, parity=False, init=(st, po, ve),
                solver_batch=psolver),
            static_argnums=4)
        eng = mpc.MpcEngine(pcfg)
        carry = (eng.init_batch_state(args.batch), sb.robot_pose,
                 sb.current_vel)
        t0 = time.time()
        ticks = 0
        while ticks < args.quality_ticks:
            run = simp(sb, *carry, args.ticks)
            carry = (run.final_state, run.poses[:, -1], run.cmds[:, -1])
            ticks += args.ticks
        dist = run.goal_dist[:, -1]
        sync(dist)
        reached = dist < 0.10
        blocked = run.collisions[:, -1] | run.lethal[:, -1]
        n_un = float(jnp.sum(~reached))
        rec = {
            "pass": name,
            "map_cells": int(sb.costmap.data.shape[-1]),
            "solver_cap": int(solver_cap or pcfg.solver_max_iters),
            "quality_ticks": ticks,
            "goal_reached_frac": round(float(jnp.mean(reached)), 4),
            "final_dist_p50_m": round(float(jnp.percentile(dist, 50)), 4),
            "unreached_blocked_frac": round(
                float(jnp.sum(blocked & ~reached) / max(n_un, 1.0)), 4),
            "mean_iters": round(float(jnp.mean(jnp.asarray(
                run.solver_iters, jnp.float32))), 2),
            "wall_s": round(time.time() - t0, 1),
        }
        print(json.dumps(rec), flush=True)
        return rec

    passes = args.passes.split(",")
    sb64 = suite(64) if {"map64", "embed_lethal"} & set(passes) else None
    if "map64" in passes:
        run_pass("map64", sb64)
    if "map128" in passes or "map128_cap16" in passes:
        sb128 = suite(128)
        if "map128" in passes:
            run_pass("map128", sb128)
        if "map128_cap16" in passes:
            run_pass("map128_cap16", sb128,
                     solver_cap=2 * pcfg.solver_max_iters)
    if "embed_lethal" in passes:
        run_pass("embed_lethal", embed(sb64, fill=1.0))


if __name__ == "__main__":
    main()
