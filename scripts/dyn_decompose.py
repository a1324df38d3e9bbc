"""Dynamic-regime decomposition (round-3 verdict weak #3): where does the
dynamic-obstacle pass's overhead go, per map size?

Times three closed-loop programs at the bench shapes (batch, ticks) and one
synthesis-only program:

  static          : fixed map (the headline regime)
  dynamic         : full per-tick on-device blob re-synthesis (the bench's
                    dynamic row — synthesis cost scales O(B·O·H·W))
  updates         : per-tick 16² dirty-window writes (Costmap.update_window —
                    the realistic live-costmap pattern; synthesis O(B·U²))
  synthesis-only  : the blob_maps + flatten work alone, scanned over ticks
                    (attribution for the dynamic row)

Prints one JSON line per program with ms/tick; run on the GPU (single
process): python scripts/dyn_decompose.py
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
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.scenarios import blob_maps, make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate

    cfg = mpc.fleet_config().replace(
        max_plan_points=64,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)

    B, T, M = args.batch, args.ticks, args.map_size
    sb = make_scenario_batch(cfg, B, seed=0, map_size=M, plan_points=64,
                             maps_on_device=True)
    rng = np.random.default_rng(3)
    half = M * 0.05 / 2
    n_obs = 6
    dyn = (jnp.asarray(rng.uniform(-half + 0.8, half - 0.3, (B, n_obs, 2)),
                       jnp.float32),
           jnp.asarray(rng.uniform(0.3, 0.95, (B, n_obs)), jnp.float32),
           jnp.asarray(rng.uniform(-0.25, 0.25, (B, n_obs, 2)), jnp.float32))
    upd = (jnp.asarray(rng.uniform(-half + 0.8, half - 0.3, (B, 2)),
                       jnp.float32),
           jnp.asarray(rng.uniform(0.3, 0.95, (B,)), jnp.float32),
           jnp.asarray(rng.uniform(-0.25, 0.25, (B, 2)), jnp.float32))

    def timed(name, fn, *a):
        out = fn(*a)
        np.asarray(jax.device_get(jax.tree.leaves(out)[0]))  # compile+barrier
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = fn(*a)
            np.asarray(jax.device_get(jax.tree.leaves(out)[0]))
            best = min(best, time.perf_counter() - t0)
        print(json.dumps({"program": name, "map_size": M, "batch": B,
                          "ticks": T, "ms_per_tick": round(best / T * 1e3, 3),
                          "solves_per_sec": round(B * T / best, 1)}),
              flush=True)
        return best

    sim_s = jax.jit(lambda b, t: batch_simulate(cfg, b, t), static_argnums=1)
    timed("static", lambda: sim_s(sb, T).cmds)

    sim_d = jax.jit(lambda b, c, a2, v, t: batch_simulate(
        cfg, b, t, dynamic_obstacles=(c, a2, v)), static_argnums=4)
    timed("dynamic_resynth", lambda: sim_d(sb, *dyn, T).cmds)

    sim_u = jax.jit(lambda b, c, a2, v, t: batch_simulate(
        cfg, b, t, costmap_updates=(c, a2, v), update_cells=16),
        static_argnums=4)
    timed("dynamic_updates", lambda: sim_u(sb, *upd, T).cmds)

    # Synthesis-only: the per-tick blob field + flatten, scanned like the sim
    # (attribution: dynamic_resynth - static - this ~= residual engine cost
    # of consuming a fresh map).
    dt = jnp.float32(cfg.control_interval)

    def synth_only(c, a2, v, t_count):
        def tick(carry, t):
            ct = c + (t.astype(jnp.float32) * dt)[..., None, None] * v
            data = blob_maps(ct, a2, M, 0.05, None, origin=sb.costmap.origin)
            flat = data.reshape(B, M * M)
            return carry + flat[:, 0], None

        acc, _ = jax.lax.scan(tick, jnp.zeros((B,), jnp.float32),
                              jnp.arange(t_count))
        return acc

    synth = jax.jit(synth_only, static_argnums=3)
    timed("synthesis_only", lambda: synth(*dyn, T))


if __name__ == "__main__":
    main()
