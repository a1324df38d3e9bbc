"""Dump the compiled HLO of the headline sim and locate named fusions.

The trace gives device-op names (fusion.362, slice_reduce_fusion.50, ...);
this maps them back to source via the HLO metadata op_name/source_file.

  python scripts/dump_hlo.py --find slice_reduce_fusion.50 fusion.362
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--out", default="/tmp/headline_hlo.txt")
    ap.add_argument("--find", nargs="*", default=[])
    args = ap.parse_args()

    import jax

    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate

    cfg = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64, solver_max_iters=8,
        solver_max_backtracks=7, solver_ls_coarse_after=2,
        solver_ls_coarse_factor=0.0625,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0, costmap_sampling="onehot",
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )
    sb = make_scenario_batch(cfg, args.batch, seed=0,
                             map_size=args.map_size, plan_points=64)
    sim = jax.jit(lambda b, t: batch_simulate(cfg, b, t), static_argnums=1)
    txt = sim.lower(sb, args.ticks).compile().as_text()
    with open(args.out, "w") as f:
        f.write(txt)
    print(f"wrote {len(txt)} bytes to {args.out}")
    if args.find:
        lines = txt.splitlines()
        for pat in args.find:
            print(f"\n=== {pat} ===")
            for i, ln in enumerate(lines):
                if pat in ln:
                    print(ln[:300])


if __name__ == "__main__":
    main()
