"""Sweep the Armijo schedule (solver_ls_backtrack, solver_max_backtracks).

Two measurements per combo, one process, run on the GPU in the default env:

1. Throughput: the bench.py headline closed loop (batch x ticks, each timed
   run ended by a host fetch).
2. Fidelity: a 30-tick closed loop at --fidelity-batch lanes, commands diffed
   against the GOLD program (library default: max_iters=40, backtrack 0.5,
   budget 16) — the same methodology as the PERF.md solver_max_iters cap
   study. Report p99/max |command diff| and the mean final goal distance.

  python scripts/sweep_ls.py --combos 0.5:16 0.25:8 0.35:10
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--max-iters", type=int, default=8)
    ap.add_argument("--fidelity-batch", type=int, default=2048)
    ap.add_argument("--fidelity-ticks", type=int, default=30)
    ap.add_argument("--combos", nargs="*", default=["0.5:16", "0.25:8"],
                    help="backtrack:budget[:coarse_after:coarse_factor] "
                         "combos (0.5:16 = current default; e.g. 0.5:9:2:0.25"
                         " = fine 0.5 for 2 trips then 0.25)")
    ap.add_argument("--no-fidelity", action="store_true")
    ap.add_argument("--qp-iters", type=int, default=0,
                    help="override cfg.qp_iters for all combos (0 = default)")
    ap.add_argument("--quad-interp", action="store_true",
                    help="quadratic-interpolation backtracking "
                         "(solver_ls_quad_interp)")
    ap.add_argument("--warm-alpha", action="store_true",
                    help="enable solver_ls_warm_alpha for all combos")
    ap.add_argument("--u8", action="store_true",
                    help="enable solver_costmap_u8 for all combos (maps are "
                         "snapped to the /255 grid so values stay exact)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate

    def sync(x):
        return np.asarray(jax.device_get(x[..., :1, 0]))

    base = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        solver_max_iters=args.max_iters,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        costmap_sampling="onehot",
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )
    if args.qp_iters:
        base = base.replace(qp_iters=args.qp_iters)
    if args.warm_alpha:
        base = base.replace(solver_ls_warm_alpha=True)
    if args.quad_interp:
        base = base.replace(solver_ls_quad_interp=True)
    if args.u8:
        base = base.replace(solver_costmap_u8=True)
    sb = make_scenario_batch(base, args.batch, seed=0,
                             map_size=args.map_size, plan_points=64)
    if args.u8:
        # Snap maps onto the raw /255 grid so the u8 gather is value-exact
        # and fidelity diffs vs the f32 gold program stay meaningful.
        raw = jnp.round(sb.costmap.data * 255.0).clip(0, 255)
        sb = sb._replace(costmap=sb.costmap.replace(
            data=raw.astype(jnp.float32) / 255.0))
    fsb = None
    gold_cmds = None
    if not args.no_fidelity:
        fsb = make_scenario_batch(base, args.fidelity_batch, seed=3,
                                  map_size=args.map_size, plan_points=64)
        if args.u8:
            raw = jnp.round(fsb.costmap.data * 255.0).clip(0, 255)
            fsb = fsb._replace(costmap=fsb.costmap.replace(
                data=raw.astype(jnp.float32) / 255.0))
        gold_cfg = base.replace(solver_max_iters=40,
                                solver_ls_backtrack=0.5,
                                solver_max_backtracks=16,
                                solver_ls_coarse_after=0,
                                solver_ls_warm_alpha=False,
                                solver_costmap_u8=False,
                                qp_iters=60)
        gsim = jax.jit(lambda b, t: batch_simulate(gold_cfg, b, t),
                       static_argnums=1)
        grun = gsim(fsb, args.fidelity_ticks)
        gold_cmds = np.asarray(jax.device_get(grun.cmds))
        gd = np.asarray(jax.device_get(grun.goal_dist[:, -1]))
        print(f"gold (cap 40, bt 0.5/16): mean final goal dist {gd.mean():.4f} m")

    for combo in args.combos:
        parts = combo.split(":")
        bt_s, mb_s = parts[0], parts[1]
        ca, cf = (int(parts[2]), float(parts[3])) if len(parts) >= 4 else (0, 0.25)
        cfg = base.replace(solver_ls_backtrack=float(bt_s),
                           solver_max_backtracks=int(mb_s),
                           solver_ls_coarse_after=ca,
                           solver_ls_coarse_factor=cf)
        sim = jax.jit(lambda b, t: batch_simulate(cfg, b, t), static_argnums=1)
        run = sim(sb, args.ticks)
        sync(run.cmds)  # compile + warm
        # Min of 3: one host stall would otherwise poison a single-rep
        # number.
        dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run = sim(sb, args.ticks)
            sync(run.cmds)
            dt = min(dt, time.perf_counter() - t0)
        sps = args.batch * args.ticks / dt
        unconv = float(1.0 - jnp.mean(jnp.asarray(run.converged, jnp.float32)))

        line = (f"bt={combo:>12}: {sps/1e3:8.1f}k solves/s "
                f"unconverged {unconv:.4f}")
        if gold_cmds is not None:
            fsim = jax.jit(lambda b, t: batch_simulate(cfg, b, t),
                           static_argnums=1)
            frun = fsim(fsb, args.fidelity_ticks)
            cmds = np.asarray(jax.device_get(frun.cmds))
            diff = np.abs(cmds - gold_cmds)
            gd = np.asarray(jax.device_get(frun.goal_dist[:, -1]))
            within = float(np.mean(np.all(diff < 0.01, axis=(1, 2))))
            line += (f" | vs gold: p99 {np.percentile(diff, 99):.4f} "
                     f"max {diff.max():.3f} lanes<0.01 {within:.3f} "
                     f"goal_dist {gd.mean():.4f}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
