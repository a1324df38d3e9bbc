"""Device-op breakdown of the headline closed-loop tick.

Runs a few ticks of the bench.py headline program under jax.profiler and
prints the top device ops by aggregate duration. Trace size (not compute)
bounds the tick count — keep --ticks small.

  python scripts/trace_headline.py --ticks 4
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import tempfile

import numpy as np


def top_device_ops(logdir: str, n: int = 40):
    paths = glob.glob(f"{logdir}/plugins/profile/*/*.trace.json.gz")
    if not paths:
        return []
    with gzip.open(sorted(paths)[-1]) as f:
        tr = json.load(f)
    events = tr.get("traceEvents", [])
    device_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname = str(e.get("args", {}).get("name", ""))
            if "/device:" in pname or "GPU" in pname:
                device_pids.add(e.get("pid"))
    agg = {}
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in device_pids:
            name = str(e.get("name", ""))
            dur = float(e.get("dur", 0.0)) / 1e3
            c, t = agg.get(name, (0, 0.0))
            agg[name] = (c + 1, t + dur)
    return sorted(agg.items(), key=lambda kv: -kv[1][1])[:n]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--max-iters", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    # Round-4 verdict item 2 instrumentation: the bench's batch-1
    # `device_p99_ms` tripled (0.308 -> 0.894 ms) when quad-interp shipped in
    # fleet_config. --step-mode traces the EXACT program behind that row
    # (MpcEngine.batch_step per tick, not the scanned closed loop);
    # --quad-interp toggles the knob so the A/B isolates its device cost.
    ap.add_argument("--step-mode", action="store_true",
                    help="trace per-tick MpcEngine.batch_step instead of "
                         "the scanned closed loop")
    ap.add_argument("--quad-interp", action="store_true",
                    help="solver_ls_quad_interp=True (the fleet_config knob)")
    ap.add_argument("--reps", type=int, default=8,
                    help="step-mode: traced step count")
    args = ap.parse_args()

    import jax

    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate
    from neo_mpc_planner2_tpu.utils.profiling import device_trace

    def sync(x):
        return np.asarray(jax.device_get(x[..., :1, 0]))

    cfg = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        solver_max_iters=args.max_iters,
        # bench.py headline operating point (two-phase Armijo schedule).
        solver_max_backtracks=7, solver_ls_coarse_after=2,
        solver_ls_coarse_factor=0.0625,
        solver_ls_quad_interp=args.quad_interp,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        costmap_sampling="onehot",
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )
    sb = make_scenario_batch(cfg, args.batch, seed=0,
                             map_size=args.map_size, plan_points=64,
                             maps_on_device=True)
    if args.step_mode:
        # The bench device_p99_ms program: a pipelined eng.batch_step chain
        # (state threaded, fetch per step — what a co-located single-robot
        # deployment pays per tick).
        from neo_mpc_planner2_tpu.utils.profiling import (
            device_module_durations_ms)

        eng = mpc.MpcEngine(cfg)
        st = eng.init_batch_state(args.batch)
        a = (sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
             sb.footprint, sb.delta_t)
        o = eng.batch_step(st, *a)
        sync(o.cmd_vel)
        st = o.state
        with tempfile.TemporaryDirectory() as td:
            with device_trace(td):
                for _ in range(args.reps):
                    o = eng.batch_step(st, *a)
                    st = o.state
                    sync(o.cmd_vel)
            rows = top_device_ops(td, args.top)
            mods = device_module_durations_ms(td)
        if mods:
            durs = max(mods.values(), key=len)[1:]
            if durs:
                d = np.array(durs)
                print(f"step module: n={d.size} p50={np.percentile(d,50):.3f}"
                      f" p99={np.percentile(d,99):.3f} max={d.max():.3f} ms")
        total = sum(t for _, (_, t) in rows)
        print(f"top {len(rows)} device ops, {args.reps} steps @ batch "
              f"{args.batch} quad={args.quad_interp} (sum {total:.1f} ms):")
        for name, (cnt, t) in rows:
            print(f"  {t:8.2f} ms  x{cnt:<5d} {name[:110]}")
        return
    sim = jax.jit(lambda b, t: batch_simulate(cfg, b, t), static_argnums=1)
    run = sim(sb, args.ticks)
    sync(run.cmds)  # compile + warm
    with tempfile.TemporaryDirectory() as td:
        with device_trace(td):
            run = sim(sb, args.ticks)
            sync(run.cmds)
        rows = top_device_ops(td, args.top)
    total = sum(t for _, (_, t) in rows)
    print(f"top {len(rows)} device ops, {args.ticks} ticks @ batch "
          f"{args.batch} quad={args.quad_interp} (sum {total:.1f} ms):")
    for name, (cnt, t) in rows:
        print(f"  {t:8.2f} ms  x{cnt:<5d} {name[:110]}")


if __name__ == "__main__":
    main()
