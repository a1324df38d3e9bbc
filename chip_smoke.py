#!/usr/bin/env python3
"""Bring-up smoke run of the MPC engine on NVIDIA GPUs, through the entry
points a user calls, at the size a fleet deployment uses.

    python chip_smoke.py          # phases 0-4 on one GPU
    python chip_smoke.py --four   # phase 5 only: four GPUs against one

Phases, in order (any failure exits non-zero; nothing is skipped):

0. Device: a GPU is required (no CPU fallback). Prints the device kind and
   count, XLA_FLAGS, and nvidia-smi's card name and power limit.
1. Fleet closed loop: `batch_simulate` with `fleet_config()` at 4096
   robots, 64² maps, 0.8 s horizon, 3 control steps, 20 ticks. Prints
   compile time, steady solves/s, memory analysis and peak memory; checks
   the batched QP took the Triton kernel; times the same loop with the
   plain XLA QP and checks the first tick's commands match. Also prints
   parity and product-mode goal capture on a goal-reachable suite.
2. Parity against the scipy oracle on the card: the MPO-700 suite (n=64,
   as tests/test_mpo700_suite.py builds it) and 64 lanes of a 4096-lane
   solve that went through the kernel.
3. Served path: `serving.serve` in a thread of this process, driven by
   `OptimizerClient` (set_costmap, set_footprint, optimizer, tick,
   optimizer_batch with 64 robots).
4. Kernels: the fused QP kernel at B=4096, m=9 and m=15, qp_iters=60,
   against the plain reference at Precision.HIGHEST, and timed in-graph
   against XLA's plain version at B in {64, 256, 4096} (m=9).
5. (--four) ShardedEngine over 4 GPUs at 4x4096 lanes and the serving
   fleet over 4 GPUs, each against the same lanes on one GPU, with each
   GPU's peak memory.

The last line printed is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import json
import os
import shutil
import socket
import subprocess
import tempfile
import threading
import time

import numpy as np

FLEET = 4096          # robots in the fleet phases
TICKS = 20            # closed-loop ticks per timed segment
QUALITY_TICKS = 160   # goal-capture horizon (8 chained segments)
SERVED_FLEET = 64     # robots in the served optimizer_batch request


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def timed(fn, *args, reps: int = 3):
    """Min wall seconds over `reps` calls, each ended by block_until_ready."""
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def peak_bytes(dev) -> int:
    """Peak device memory in use so far (-1 where the backend keeps none)."""
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def bench_cfg(control_steps: int = 3):
    """The fleet operating point at the bench's weights and shapes."""
    import neo_mpc_planner2_tpu as mpc

    return mpc.fleet_config().replace(
        prediction_horizon=0.8, control_steps=control_steps,
        opt_tolerance=1e-3, footprint_edge_samples=16, max_plan_points=64,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0, costmap_sampling="onehot",
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def parity_cfg(cfg):
    """The library-default solver program (scipy-parity contract) on cfg's
    weights and shapes, at the MPO-700 suite's tight tolerance."""
    import neo_mpc_planner2_tpu as mpc

    d = mpc.default_config()
    return cfg.replace(
        opt_tolerance=1e-8, solver_max_iters=d.solver_max_iters,
        solver_max_backtracks=d.solver_max_backtracks,
        solver_ls_coarse_after=d.solver_ls_coarse_after,
        solver_ls_coarse_factor=d.solver_ls_coarse_factor,
        solver_ls_quad_interp=d.solver_ls_quad_interp,
        solver_costmap_u8=d.solver_costmap_u8)


def assert_commands(cmds, max_trans: float, what: str) -> None:
    cmds = np.asarray(cmds)
    check(np.all(np.isfinite(cmds)), f"{what}: non-finite commands")
    speed = np.linalg.norm(cmds[..., :2], axis=-1)
    check(float(speed.max()) <= max_trans + 1e-5,
          f"{what}: |cmd_xy| {float(speed.max())} > max_vel_trans {max_trans}")


@contextlib.contextmanager
def plain_qp_only():
    """Trace the batched QP on the plain XLA path on every platform (the
    kernel's reference in phase 1). Affects what is traced inside."""
    from neo_mpc_planner2_tpu import sqp

    saved = sqp._by_platform
    sqp._by_platform = lambda args, kernel, plain: plain(*args)
    try:
        yield
    finally:
        sqp._by_platform = saved


# ---------------------------------------------------------------- phase 0
def phase_device():
    import jax

    devs = jax.devices()
    plat = devs[0].platform
    if plat != "gpu":
        fail(f"no GPU: JAX's first device is {plat!r}")
    log(f"[0] device_kind={devs[0].device_kind} count={len(devs)} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    # A child that does not import JAX reads the card's name and limit.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[0] card: {card}")
    return devs, card


# ---------------------------------------------------------------- phase 1
def phase_fleet(card: str):
    import jax
    import jax.numpy as jnp

    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate

    cfg = bench_cfg()
    sb = make_scenario_batch(cfg, FLEET, seed=0, map_size=64, plan_points=64,
                             maps_on_device=True)
    eng = mpc.MpcEngine(cfg)
    carry = (eng.init_batch_state(FLEET), sb.robot_pose, sb.current_vel)

    def sim_fn(c, ticks, parity=True):
        return jax.jit(lambda b, st, pose, vel: batch_simulate(
            c, b, ticks, parity=parity, init=(st, pose, vel)))

    t0 = time.perf_counter()
    lowered = sim_fn(cfg, TICKS).lower(sb, *carry)
    check("qp_admm" in lowered.as_text(),
          "the fleet solve did not take the QP kernel")
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    log(f"[1] fleet B={FLEET} ticks={TICKS}: compile {compile_s:.1f} s; "
        f"memory_analysis: args {mem.argument_size_in_bytes} B, "
        f"outputs {mem.output_size_in_bytes} B, "
        f"temps {mem.temp_size_in_bytes} B")
    jax.block_until_ready(compiled(sb, *carry))  # first run
    sim_s, run = timed(compiled, sb, *carry)
    dev = jax.devices()[0]
    log(f"[1] fleet steady: {sim_s * 1e3:.2f} ms / {TICKS} ticks = "
        f"{FLEET * TICKS / sim_s:.1f} solves/s; "
        f"peak_bytes_in_use {peak_bytes(dev)} ({card})")
    check(run.cmds.shape == (FLEET, TICKS, 3), f"cmds shape {run.cmds.shape}")
    assert_commands(run.cmds, cfg.max_vel_trans, "fleet")
    log(f"[1] mean solver iters {float(jnp.mean(run.solver_iters)):.2f}, "
        f"converged {float(jnp.mean(run.converged)):.4f}")

    # The same closed loop with the plain XLA QP on this GPU: the kernel's
    # end-to-end reference, in speed and in commands.
    with plain_qp_only():
        lowered = sim_fn(cfg, TICKS).lower(sb, *carry)
    check("qp_admm" not in lowered.as_text(), "plain program took the kernel")
    plain = lowered.compile()
    jax.block_until_ready(plain(sb, *carry))
    plain_s, plain_run = timed(plain, sb, *carry)
    log(f"[1] same loop, plain XLA QP: {plain_s * 1e3:.2f} ms / {TICKS} "
        f"ticks = {FLEET * TICKS / plain_s:.1f} solves/s; kernel x"
        f"{plain_s / sim_s:.2f} end to end ({card})")
    first_plain = np.asarray(plain_run.cmds[:, 0])
    first_kernel = np.asarray(run.cmds[:, 0])
    diff = np.abs(first_kernel - first_plain).max(axis=-1)
    # The kernel sums in another order than XLA's fused matvecs (float32
    # reassociation, ~1e-6); the SQP's accept/terminate tests can turn such a
    # difference into one more or one fewer iteration on a lane, so the gate
    # is on the share of lanes that agree, not on every lane.
    tol, need = 1e-4, 0.99
    frac = float(np.mean(diff <= tol))
    last = np.abs(np.asarray(run.cmds[:, -1])
                  - np.asarray(plain_run.cmds[:, -1])).max(axis=-1)
    log(f"[1] kernel vs plain QP, first tick, {FLEET} lanes: max |dcmd| "
        f"{diff.max():.3e}, p99 {np.percentile(diff, 99):.3e}, "
        f"share within {tol:g} m/s = {frac:.4f} (gate >= {need}); tick "
        f"{TICKS}: p99 {np.percentile(last, 99):.3e}, max {last.max():.3e}")
    check(frac >= need, "kernel commands diverge from the plain QP")

    # Goal capture on a goal-reachable suite: parity (this executable,
    # chained) and product mode (fast TF32-default patch picks).
    from neo_mpc_planner2_tpu.ops.costmap import (
        required_product_patch_halfwidth)

    def capture(c, parity):
        qsb = make_scenario_batch(c, FLEET, seed=1, map_size=64,
                                  plan_points=64, plan_length_range=(0.7, 1.1),
                                  clear_corridor_m=0.55, center_on="plan",
                                  maps_on_device=True)
        exe = (compiled if parity
               else sim_fn(c, TICKS, parity=False).lower(
                   qsb, *carry).compile())
        q = (eng.init_batch_state(FLEET), qsb.robot_pose, qsb.current_vel)
        t0 = time.perf_counter()
        for _ in range(QUALITY_TICKS // TICKS):
            r = exe(qsb, *q)
            q = (r.final_state, r.poses[:, -1], r.cmds[:, -1])
        dist = np.asarray(r.goal_dist[:, -1])
        secs = time.perf_counter() - t0
        assert_commands(r.cmds, c.max_vel_trans, "goal-capture")
        return float(np.mean(dist < 0.10)), float(np.median(dist)), secs

    reached, p50, secs = capture(cfg, True)
    log(f"[1] parity goal capture ({QUALITY_TICKS} ticks): reached "
        f"{reached:.4f}, final dist p50 {p50:.3f} m (run in {secs:.1f} s)")
    pcfg = mpc.product_config().replace(**{
        k: getattr(cfg, k) for k in (
            "prediction_horizon", "control_steps", "opt_tolerance",
            "footprint_edge_samples", "max_plan_points", "min_vel_x",
            "min_vel_y", "min_vel_theta", "max_vel_x", "max_vel_y",
            "max_vel_trans", "max_vel_theta", "w_trans", "w_orient",
            "w_control", "w_terminal", "w_costmap", "w_footprint",
            "costmap_sampling", "lookahead_dist_min", "lookahead_dist_max",
            "lookahead_dist_close_to_goal")})
    pcfg = pcfg.replace(solver_costmap_patch=(
        required_product_patch_halfwidth(pcfg, 0.05, 0.46)))
    reached, p50, secs = capture(pcfg, False)
    log(f"[1] product-mode goal capture ({QUALITY_TICKS} ticks, "
        f"solver_patch_exact_picks=False: backend-default picks, TF32 on "
        f"this card): reached {reached:.4f}, final dist p50 {p50:.3f} m "
        f"(run in {secs:.1f} s)")
    return sb


# ---------------------------------------------------------------- phase 2
def phase_parity(sb_fleet):
    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.oracle import check_against_oracle
    from neo_mpc_planner2_tpu.ops.footprint import Footprint
    from neo_mpc_planner2_tpu.scenarios import (MPO700_LENGTH, MPO700_WIDTH,
                                                make_scenario_batch)

    match_gate, gap_gate = 0.9, 5e-4  # tests/test_mpo700_suite.py's gate
    cfg = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-8,
        footprint_edge_samples=8, max_plan_points=64,
        acc_x_limit=2.5, acc_y_limit=2.5, acc_theta_limit=3.0,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)
    fp = Footprint.rectangle(MPO700_LENGTH, MPO700_WIDTH,
                             cfg.max_footprint_vertices)
    sb = make_scenario_batch(cfg, 64, seed=123, map_size=48, plan_points=48,
                             footprint=fp)
    hl, hw = MPO700_LENGTH / 2, MPO700_WIDTH / 2
    fp_np = np.array([[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]])

    def gate(name, st):
        frac = st.matched / max(st.checked, 1)
        log(f"[2] {name}: matched {st.matched}/{st.checked} = {frac:.4f} "
            f"(gate >= {match_gate}), worst gap {st.worst_gap:.3e}, worst "
            f"unmatched gap {st.worst_unmatched_gap:.3e} (gate < {gap_gate})")
        check(st.checked >= 48, f"{name}: only {st.checked} lanes checked")
        check(frac >= match_gate, f"{name}: matched share {frac}")
        check(st.worst_unmatched_gap < gap_gate, f"{name}: objective gap")
        check(st.fp_nonzero == 0, f"{name}: footprint branch not zeroed")

    t0 = time.perf_counter()
    gate("MPO-700 suite n=64", check_against_oracle(cfg, sb, fp_np))
    # Phase 1's fleet: all 4096 lanes in one dispatch (the kernel path), at
    # the parity solver program; the oracle checks the first 64.
    pcfg = parity_cfg(bench_cfg())
    gate(f"fleet batch, 64 of {FLEET} kernel-path lanes",
         check_against_oracle(pcfg, sb_fleet, lanes=range(64)))
    log(f"[2] parity phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 3
def phase_served():
    import neo_mpc_planner2_tpu as mpc
    from neo_mpc_planner2_tpu.serving import OptimizerClient, serve

    cfg = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, footprint_edge_samples=16,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ready = threading.Event()
    threading.Thread(target=serve, kwargs=dict(
        host="127.0.0.1", port=port, cfg=cfg, ready_event=ready),
        daemon=True).start()
    check(ready.wait(60), "server did not start")
    client = OptimizerClient(port=port, wait_timeout=30)

    def call(msg):
        t0 = time.perf_counter()
        r = client.call(msg)
        ms = (time.perf_counter() - t0) * 1e3
        check("error" not in r, f"{msg['op']}: {r.get('error')}")
        return r, ms

    rng = np.random.default_rng(0)
    grid = np.clip(rng.uniform(0, 0.3, (64, 64)), 0, 1)
    call({"op": "set_costmap", "data": grid.tolist(), "origin": [-1.6, -1.6],
          "resolution": 0.05})
    call({"op": "set_footprint",
          "points": [[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]]})
    req = {"op": "optimizer", "current_pose": [0, 0, 0],
           "carrot_pose": [0.4, 0.1, 0.2], "goal_pose": [1.0, 0.5, 0.3],
           "current_vel": [0.3, 0, 0], "control_interval": 0.033}
    cmds, lat = [], []
    for _ in range(6):
        r, ms = call(req)
        cmds.append(r["output_vel"])
        lat.append(ms)
    log(f"[3] optimizer: first {lat[0]:.1f} ms (compile), then "
        f"{', '.join(f'{x:.2f}' for x in lat[1:])} ms")
    plan = np.stack([np.linspace(0, 1.2, 40), np.linspace(0, 0.3, 40),
                     np.zeros(40)], 1)
    call({"op": "set_plan", "poses": plan.tolist()})
    pose, vel, lat = np.zeros(3), np.zeros(3), []
    for _ in range(6):
        r, ms = call({"op": "tick", "pose": pose.tolist(),
                      "vel": vel.tolist()})
        vel = np.asarray(r["output_vel"])
        pose = pose + vel * 0.033
        cmds.append(r["output_vel"])
        lat.append(ms)
    log(f"[3] tick: first {lat[0]:.1f} ms (compile), then "
        f"{', '.join(f'{x:.2f}' for x in lat[1:])} ms")
    robots = [{"current_pose": [0.01 * i, 0, 0],
               "carrot_pose": [0.4, 0.1 - 0.002 * i, 0.2],
               "goal_pose": [1.0, 0.5, 0.3], "current_vel": [0.3, 0, 0],
               "control_interval": 0.033} for i in range(SERVED_FLEET)]
    lat = []
    for _ in range(4):
        r, ms = call({"op": "optimizer_batch", "robots": robots})
        check(len(r["results"]) == SERVED_FLEET, "optimizer_batch size")
        cmds += [x["output_vel"] for x in r["results"]]
        lat.append(ms)
    log(f"[3] optimizer_batch x{SERVED_FLEET}: first {lat[0]:.1f} ms "
        f"(compile), then {', '.join(f'{x:.2f}' for x in lat[1:])} ms")
    client.close()
    assert_commands(cmds, cfg.max_vel_trans, "served")


# ---------------------------------------------------------------- phase 4
def qp_inputs(rng, B: int, m: int):
    """A random batch of well-posed QPs in the solver's shapes."""
    import jax.numpy as jnp

    n = m // 3
    A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
    Bmat = A @ np.swapaxes(A, -1, -2) + np.eye(m, dtype=np.float32)
    g = rng.normal(size=(B, m)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (B, m)).astype(np.float32)
    xy = x.reshape(B, n, 3)[:, :, :2]
    nrm = np.maximum(np.linalg.norm(xy, axis=-1), 1e-12)
    c = (0.7 - nrm).astype(np.float32)
    J = np.zeros((B, n, m), np.float32)
    for k in range(n):
        J[:, k, 3 * k] = -xy[:, k, 0] / nrm[:, k]
        J[:, k, 3 * k + 1] = -xy[:, k, 1] / nrm[:, k]
    lo = np.full((B, m), -0.7, np.float32)
    carry = [rng.normal(size=(B, r)).astype(np.float32) * 0.1
             for r in (m, m, n, m, n)]
    return [jnp.asarray(a) for a in
            (Bmat.reshape(B, m * m), g, x, c, J, lo, -lo, *carry)]


def ptxas_usage(dump_dir: str) -> str:
    """Registers and spill bytes that ptxas reports for the kernel with the
    most registers in XLA's PTX dump (the QP kernel), or why not known."""
    ptxas = shutil.which("ptxas") or "/usr/local/cuda/bin/ptxas"
    if not os.path.exists(ptxas):
        return "not measured (no ptxas)"
    best = None
    for path in sorted(glob.glob(os.path.join(dump_dir, "*.ptx"))):
        out = subprocess.run([ptxas, "-v", "-arch=sm_90a", path, "-o",
                              os.devnull], capture_output=True, text=True,
                             timeout=600)
        name, spill = None, ""
        for line in (out.stdout + out.stderr).splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line and name:
                words = line.split("Used")[1].split()
                if words and words[0].isdigit() and (
                        best is None or int(words[0]) > best[0]):
                    best = (int(words[0]), name, spill)
    if best is None:
        return "not measured (no PTX entry in the dump)"
    return f"{best[0]} registers ({best[2]}) in {best[1][:60]}"


def phase_kernels(card: str):
    import jax
    import jax.numpy as jnp

    from neo_mpc_planner2_tpu import sqp

    kw = dict(iters=60, rho=1.0, sigma=1e-6)
    rng = np.random.default_rng(0)
    rtol, atol = 2e-4, 2e-5
    reps = 20

    def chained(qp, lane_minor_j):
        """jit: `n` QPs back to back, each warm-started from the last one's
        ADMM state as the SQP does, so the timing is the in-graph cost of
        one QP without the host's per-call dispatch."""
        def run(n, *args):
            head, carry = list(args[:7]), tuple(args[7:])
            if lane_minor_j:  # the kernel takes the Jacobian's nonzeros
                J = head[4]
                head[4] = jnp.stack([J[:, k, 3 * k + a]
                                     for k in range(J.shape[1])
                                     for a in (0, 1)], axis=-1)
            return jax.lax.fori_loop(
                0, n, lambda _, c: tuple(qp(*head, *c)[2:]), carry)
        return jax.jit(run)

    def compiled(qp, lane_minor_j, args, highest=False, dump=None):
        t0 = time.perf_counter()
        with (jax.default_matmul_precision("highest") if highest
              else contextlib.nullcontext()):
            fn = chained(qp, lane_minor_j).lower(1, *args).compile(
                compiler_options={"xla_dump_to": dump} if dump else None)
        return fn, time.perf_counter() - t0

    plain_qp = jax.vmap(functools.partial(sqp._qp_admm_plain, **kw))

    def measure(m, B, block=sqp._QP_BLOCK, dump=None):
        args = qp_inputs(rng, B, m)
        kernel, compile_s = compiled(functools.partial(
            sqp._qp_admm_triton, block=block, **kw), True, args, dump=dump)
        tk, _ = timed(kernel, reps, *args)
        return args, kernel, compile_s, tk / reps

    # m=9 (3 control steps): batch sweep against XLA, then lanes per
    # program; m=15 (5 steps): the fleet batch only (its kernel compile
    # is the slow one, PERF.md).
    for m, batches in ((9, (64, 256, FLEET)), (15, (FLEET,))):
        for B in batches:
            dump = tempfile.mkdtemp(prefix="qp_ptx_") if B == FLEET else None
            args, kernel, compile_s, tk = measure(m, B, dump=dump)
            if dump:
                log(f"[4] qp_admm m={m} registers: {ptxas_usage(dump)}")
                shutil.rmtree(dump, ignore_errors=True)
            plain, _ = compiled(plain_qp, False, args, highest=True)
            got = jax.block_until_ready(kernel(1, *args))
            want = jax.block_until_ready(plain(1, *args))
            err = max(float(jnp.max(jnp.abs(a - b) / (atol + rtol * jnp.abs(b))))
                      for a, b in zip(got, want))
            check(err <= 1.0, f"QP kernel m={m} B={B}: error {err} x tol")
            tp, _ = timed(plain, reps, *args)
            tp /= reps
            log(f"[4] qp_admm m={m} B={B} iters=60, in-graph per QP: "
                f"kernel {tk * 1e6:.1f} us, XLA plain {tp * 1e6:.1f} us "
                f"(x{tp / tk:.2f}); kernel compile {compile_s:.1f} s; "
                f"max err {err:.3f} of |d|<=atol {atol:g}+rtol {rtol:g}, "
                f"plain reference at Precision.HIGHEST ({card})")
    sweep = []
    for block in (32, 64, 128):
        *_, compile_s, tk = measure(9, FLEET, block)
        sweep.append(f"block {block}: {tk * 1e6:.1f} us "
                     f"(compile {compile_s:.1f} s)")
    log(f"[4] qp_admm m=9 B={FLEET} lanes per program: {'; '.join(sweep)} "
        f"({card})")


# ---------------------------------------------------------------- phase 5
def phase_four(card: str):
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from neo_mpc_planner2_tpu.parallel.sharding import ShardedEngine, make_mesh
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.serving import OptimizerSession

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    cfg = bench_cfg()
    lanes = 4 * FLEET
    # A flat mesh: every card reaches every other over NVLink, one process.
    four = ShardedEngine(cfg, make_mesh(devs, hosts=1), donate_state=False)
    sb = make_scenario_batch(cfg, lanes, seed=0, map_size=64, plan_points=64)
    dts = np.full((lanes,), cfg.control_interval, np.float32)
    host_args = jax.device_get((sb.plan, sb.robot_pose, sb.current_vel,
                                sb.costmap, sb.footprint, dts))
    del sb
    st4 = four.init_state(lanes)
    a4 = four.shard(host_args)
    out4, _ = four.step(st4, *a4)
    t4, _ = timed(lambda: four.step(st4, *a4))
    cmd4 = np.asarray(out4.cmd_vel)
    shard_devs = {s.device for s in out4.cmd_vel.addressable_shards}
    check(len(shard_devs) == 4, "ShardedEngine output not spread over 4")

    # Serving fleet: _fleet_jit shards the lanes over every visible device.
    stage = [{"op": "set_costmap", "data": np.zeros((64, 64)).tolist(),
              "origin": [-1.6, -1.6], "resolution": 0.05},
             {"op": "set_footprint", "points": [[0.3, 0.2], [-0.3, 0.2],
                                                [-0.3, -0.2], [0.3, -0.2]]}]
    robots = [{"current_pose": [0.0001 * i, 0, 0],
               "carrot_pose": [0.4, 0.1 - 0.00002 * i, 0.2],
               "goal_pose": [1.0, 0.5, 0.3], "current_vel": [0.3, 0, 0],
               "control_interval": 0.033} for i in range(FLEET)]

    def serve_fleet():
        s = OptimizerSession(cfg, fleet_chunk=0)
        for m in stage:
            s.handle(m)
        msg = {"op": "optimizer_batch", "robots": robots, "delta_t": 0.033}
        r = s.handle(msg)  # compile + first tick
        check("error" not in r, f"optimizer_batch: {r.get('error')}")
        s.handle({"op": "reset"})
        t0 = time.perf_counter()
        r = s.handle(msg)
        ms = (time.perf_counter() - t0) * 1e3
        return np.asarray([x["output_vel"] for x in r["results"]]), ms

    s4, ms4 = serve_fleet()
    # Each card's peak so far: the 4-card programs only.
    peaks = [peak_bytes(d) for d in devs]
    log(f"[5] peak_bytes_in_use per GPU after the 4-GPU runs: {peaks}")
    check(min(peaks) > 0 and max(peaks) < 2 * min(peaks),
          "one GPU holds far more than the others")

    # The same lanes on one GPU: a 1x1 mesh, and the serving session with
    # one visible device (plain jit on the default device).
    one = ShardedEngine(cfg, make_mesh(devs[:1], hosts=1), donate_state=False)
    st1 = one.init_state(lanes)
    a1 = one.shard(host_args)
    out1, _ = one.step(st1, *a1)
    t1, _ = timed(lambda: one.step(st1, *a1))
    diff = np.abs(cmd4 - np.asarray(out1.cmd_vel)).max(axis=-1)
    log(f"[5] ShardedEngine {lanes} lanes: 1 GPU {t1 * 1e3:.2f} ms/step, "
        f"4 GPUs {t4 * 1e3:.2f} ms/step ({lanes / t4:.1f} solves/s, "
        f"x{t1 / t4:.2f}); max |dcmd| {diff.max():.3e} ({card})")
    check(float(np.mean(diff <= 1e-4)) >= 0.99,
          "ShardedEngine commands differ from one GPU")
    assert_commands(cmd4, cfg.max_vel_trans, "sharded")

    with mock.patch.object(jax, "device_count", lambda: 1):
        s1, ms1 = serve_fleet()
    sdiff = np.abs(s4 - s1).max(axis=-1)
    log(f"[5] serving fleet x{FLEET}: 1 GPU {ms1:.2f} ms, 4 GPUs "
        f"{ms4:.2f} ms per optimizer_batch; max |dcmd| {sdiff.max():.3e}")
    check(float(np.mean(sdiff <= 1e-4)) >= 0.99,
          "served fleet commands differ between 1 and 4 GPUs")
    assert_commands(s4, cfg.max_vel_trans, "served fleet")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only phase 5 (four GPUs against one)")
    args = ap.parse_args()

    import jax

    import neo_mpc_planner2_tpu
    from neo_mpc_planner2_tpu.utils.compile_cache import enable_compile_cache

    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.dirname(os.path.dirname(neo_mpc_planner2_tpu.__file__))
    check(os.path.samefile(pkg, here),
          f"the package imported from {pkg}, not from this checkout")

    log(f"[0] compile cache: {enable_compile_cache()}")
    devs, card = phase_device()
    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        sb = phase_fleet(card)
        log(f"[1] done at {time.perf_counter() - t0:.1f} s")
        phase_parity(sb)
        log(f"[2] done at {time.perf_counter() - t0:.1f} s")
        phase_served()
        log(f"[3] done at {time.perf_counter() - t0:.1f} s")
        phase_kernels(card)
        log(f"[4] done at {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
