"""Sweep lockstep-tail compaction knobs at a given solver_max_iters.

Times the bench.py headline closed loop (batch x ticks, each timed run
ended by a host fetch) for each (solver_compact_after,
solver_compact_frac) pair given on the CLI, plus the uncompacted baseline.
One process; run on the GPU in the default env.

  python scripts/sweep_compact.py --max-iters 8 --pairs 4:0.0625 4:0.125 5:0.0625
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
    ap.add_argument("--pairs", nargs="*", default=["4:0.0625", "4:0.125"],
                    help="k1:frac pairs; 0:0 = baseline (always run first); "
                         "a:frac = ADAPTIVE compaction (batch-level while "
                         "until <= frac*B lanes alive, then compact tail)")
    ap.add_argument("--ls-wave", type=int, default=1,
                    help="solver_ls_wave candidates per merit eval")
    ap.add_argument("--single-phase", action="store_true",
                    help="library-default Armijo schedule (0.5^j, budget 16) "
                         "instead of the bench two-phase b7 point — for "
                         "A/Bs against the SHIPPED default program")
    ap.add_argument("--patch", type=int, default=0,
                    help="solver_costmap_patch halfwidth; 0 = full-map "
                         "gather (the bench.py operating point), -1 = auto "
                         "(required_patch_halfwidth)")
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
        solver_ls_wave=args.ls_wave,
        # bench.py headline operating point (two-phase Armijo schedule).
        solver_max_backtracks=7, solver_ls_coarse_after=2,
        solver_ls_coarse_factor=0.0625,
    )
    if args.single_phase:
        base = base.replace(solver_max_backtracks=16,
                            solver_ls_coarse_after=0)
    if args.patch != 0:
        from neo_mpc_planner2_tpu.ops.costmap import required_patch_halfwidth
        h = (required_patch_halfwidth(base, 0.05) if args.patch < 0
             else args.patch)
        base = base.replace(solver_costmap_patch=h)
        print(f"solver_costmap_patch={h}", flush=True)
    sb = make_scenario_batch(base, args.batch, seed=0,
                             map_size=args.map_size, plan_points=64,
                             maps_on_device=True)

    ref_cmds = None
    for pair in ["0:0"] + [p for p in args.pairs if p != "0:0"]:
        k1_s, frac_s = pair.split(":")
        if k1_s == "a":
            cfg = base.replace(solver_compact_adaptive=True,
                               solver_compact_frac=float(frac_s))
        else:
            cfg = base.replace(solver_compact_after=int(k1_s),
                               solver_compact_frac=float(frac_s))
        sim = jax.jit(lambda b, t, cfg=cfg: batch_simulate(cfg, b, t),
                      static_argnums=1)
        run = sim(sb, args.ticks)
        sync(run.cmds)  # compile + warm
        s = float("inf")
        for _ in range(2):  # min-of-2: host-clock jitter
            t0 = time.perf_counter()
            run = sim(sb, args.ticks)
            sync(run.cmds)
            s = min(s, time.perf_counter() - t0)
        sps = args.batch * args.ticks / s
        cmds = np.asarray(jax.device_get(run.cmds))
        if ref_cmds is None:
            ref_cmds = cmds
            drift = 0.0
        else:
            drift = float(np.abs(cmds - ref_cmds).max())
        print(f"k1={k1_s:>2} frac={frac_s:<7} {sps:>9.1f} solves/s "
              f"({s:.2f}s)  max|cmd-base|={drift:.2e}", flush=True)


if __name__ == "__main__":
    main()
