"""Standalone optimization server — the deployment twin of the reference's
`mpc_optimization_server` node (mpc_optimization_server.py:441-447).

The reference exposes one blocking ROS service 'optimizer' (py:105) plus
topic subscriptions for the footprint (py:140-144) and parameters. Here the
transport is a newline-delimited JSON protocol over TCP (no ROS, no DDS):

    {"op": "configure", "params": {<ROS parameter names>}}
    {"op": "set_costmap", "data": [[...]], "origin": [x, y], "resolution": r}
    {"op": "set_footprint", "points": [[x, y], ...]}
    {"op": "optimizer", "current_pose": [x,y,yaw], "carrot_pose": [x,y,yaw],
     "goal_pose": [x,y,yaw], "current_vel": [vx,vy,wz],
     "switch_opt": false, "control_interval": 0.033}
    {"op": "optimizer_batch", "robots": [{<optimizer fields>}, ...],
     "control_interval": 0.033}   # fleet tick: one device batch per call
    {"op": "set_plan", "poses": [[x, y, yaw], ...]}   # full-tick mode
    {"op": "tick", "pose": [x,y,yaw], "vel": [vx,vy,wz]}
    {"op": "set_plans", "plans": [<poses>, ...]}      # batched full tick
    {"op": "tick_batch", "robots": [{"pose": …, "vel": …}, ...]}
    {"op": "save_state"/"load_state", "path": "name.npz"[, "fleet": true]}
    {"op": "release", "robot": id}  # drop one robot's session slot
    {"op": "reset"}        # new-mission reset (the reference restarts the node)
    {"op": "ping"}

Mode: sessions default to reference-parity; `OptimizerSession(...,
parity=False)` / `serve(..., parity=False)` / `neo-mpc-server --product`
serve PRODUCT mode instead — the smooth bilinear objective + true predicted
footprint through the same SQP on every path (single-robot, fleet,
full-tick). Pair with config.product_config's solver knobs.

`set_plan`/`tick` is the FULL-TICK mode the reference cannot offer: the
server runs the entire fused controller tick (plan pruning + carrot
selection + hysteresis + solve + safety post-processing — both reference
processes) on device, so a thin client sends the plan once and then only
6 floats per tick, no geometry code (and no C++ host) on the robot at all.
The lethal/empty-window plugin gates come back as response flags instead
of exceptions.

`optimizer_batch` is the fleet-serving path the reference has no analogue for
(it is strictly one robot per server process): N robots sharing the staged
costmap/footprint are solved as ONE batched device dispatch per tick, each
with its own persistent warm-start/stuck-timer lane. Robots are positional —
keep a stable order across calls; growing the fleet preserves existing lanes
and initializes the new ones (lanes beyond the previous robot count are reset
to init_state before the solve, so a new robot never inherits a pad lane's
evolved state), shrinking drops the tail. The batch is padded to a power of
two so fleet-size churn does not recompile. Response:
{"results": [<per-robot optimizer response>, ...]}. In pipelined mode a
fleet-size change returns the previous tick's results for the surviving
lanes (positions < min(old_n, new_n)) and a zero-command `pipelined_warmup`
entry only for the new lanes.

Responses mirror the Optimizer.srv response: {"output_vel": [vx, vy, wz],
...diagnostics}. Requests serialize on one lock — the same ordering
discipline as the reference's single-threaded rclpy executor (py:441-444) —
while connections are threaded, so several robot processes can stay
connected at once. Single-robot ops (optimizer/tick/set_plan/save_state/
load_state) accept an optional "robot": "<id>" field selecting an isolated
per-robot session slot (state, stuck clock, plan, pipelined pending);
omitting it uses the default slot, so a single-robot deployment needs no
ids. Wall-clock delta_t for the stuck-wait timer is measured server-side
like the reference (py:369-371) unless the request carries an explicit
"delta_t".

The device state (warm start, last control, timers) stays resident between
calls as a ControlState pytree; per tick, exactly ONE packed request vector
crosses host->device and ONE packed response vector crosses device->host
(each separate transfer is its own copy and sync).
"""

from __future__ import annotations

import dataclasses
import json
import socket
import socketserver
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import MpcConfig, config_from_ros_params, default_config
from .engine import init_state, solve_step
from .ops.costmap import Costmap, u8_source_enabled
from .ops.footprint import Footprint
from .ops.objective import Limits, Scenario, Weights, make_objective
from .sqp import make_sqp_solver

# Parameters the reference's cb_params updates in place (py:405-439): weights
# and velocity/acceleration bounds. These ride the Weights/Limits pytrees into
# the compiled step, so reconfiguring them never retraces; anything else
# (horizon, tolerances, sampling shapes) rebuilds the executable.
RUNTIME_PARAMS = frozenset({
    "w_trans", "w_orient", "w_control", "w_terminal", "w_costmap",
    "w_footprint",
    "min_vel_x", "min_vel_y", "min_vel_theta", "min_vel_trans",
    "max_vel_x", "max_vel_y", "max_vel_trans", "max_vel_theta",
    "acc_x_limit", "acc_y_limit", "acc_theta_limit",
})

__all__ = ["OptimizerSession", "serve", "OptimizerClient"]


class OptimizerSession:
    """Transport-independent request handler (also used directly in tests and
    by the C++ host front-end through the in-process path)."""

    def __init__(self, cfg: Optional[MpcConfig] = None, pipelined: bool = False,
                 checkpoint_dir: Optional[str] = None, max_slots: int = 1024,
                 slot_ttl: Optional[float] = None, parity: bool = True,
                 fleet_chunk: int = 4096):
        self.cfg = cfg or default_config()
        # Max lanes per device dispatch for the fleet paths (0 = always one
        # dispatch). Sequential equal-size dispatches reuse one executable
        # however large the fleet grows (the default chunk is a starting
        # point, not a measured optimum on every card). Chunking applies
        # only when the padded fleet splits
        # into equal device-aligned chunks; per-lane results are identical
        # (lanes are independent — tests pin equality).
        self.fleet_chunk = int(fleet_chunk)
        # parity=False serves PRODUCT mode (the smooth bilinear objective +
        # true predicted footprint through the same SQP — the recommended
        # non-parity deployment, config.product_config): every executable
        # this session builds (single-robot, fleet, full-tick) then runs the
        # product objective. Survives op_configure rebuilds.
        self.parity = parity
        # Slot lifecycle (round-3 verdict: slots never died — a long-running
        # server with churning robot ids grew device/host memory without
        # bound). max_slots is a hard LRU cap enforced when a NEW slot is
        # created; slot_ttl (seconds, None = off) additionally expires slots
        # idle longer than the TTL at the same point. Explicit release is the
        # "release" op. The monotonic clock is injectable for tests.
        self.max_slots = max(1, int(max_slots))  # >=1: the default slot must fit
        self.slot_ttl = slot_ttl
        self._slot_clock = time.monotonic
        # save_state/load_state ops resolve request paths INSIDE this
        # directory only; None disables them (the request path arrives over
        # an unauthenticated socket — it must never be an arbitrary-path
        # file write/read primitive on the server host).
        self.checkpoint_dir = checkpoint_dir
        self.costmap: Optional[Costmap] = None
        self.footprint: Optional[Footprint] = None
        # Per-robot session slots: the single-robot ops (optimizer, tick,
        # set_plan) accept an optional "robot" id so SEVERAL robot processes
        # can share one threaded server without corrupting each other's
        # warm start / collision latch / stuck clock (round-3 review — the
        # plain single-session design was only safe while the old
        # non-threading server structurally serialized whole connections).
        # Omitting "robot" uses the default slot "" — the single-robot
        # behavior of the reference. Each slot: ControlState, wall-clock
        # stuck-timer baseline (py:138 — first delta_t is huge, like
        # time.time()-0), full-tick plan, pipelined pending result.
        self._slots: dict = {}
        # The batch path keeps its own timestamp: sharing a slot clock with
        # the fleet op would corrupt both stuck-timer deltas when a client
        # interleaves single and batch solves (ADVICE round-2).
        self._fleet_last_time = 0.0
        # Advanced-step mode (SURVEY.md §7.8 double-buffered pipeline): return
        # the PREVIOUS tick's command immediately while this tick's solve runs
        # asynchronously on device — one control period of command latency in
        # exchange for hiding the full solve+transport time. Standard
        # advanced-step MPC; the reference instead blocks the controller
        # thread for the whole solve (cpp:248-250).
        self.pipelined = pipelined
        # Fleet-serving lane state: a batched ControlState whose leading dim is
        # the padded fleet size (see op_optimizer_batch), plus the pipelined-
        # mode pending result for the batch path. _fleet_n tracks how many
        # lanes hold REAL robot state (pad lanes still get solved every tick,
        # so their ControlState evolves — a robot later assigned to one must
        # start from init_state, not the polluted lane; ADVICE round-2).
        self._fleet_state = None
        self._fleet_pending = None
        self._fleet_n = 0
        # Full-tick executable (op_set_plan/op_tick); built lazily.
        self._tick_fn = None
        # Incremental costmap-update executable (op_set_costmap_update).
        self._update_fn = None
        # Batched full-tick fleet (op_set_plans/op_tick_batch): positional
        # per-lane plans + lane states, padded like op_optimizer_batch.
        self._ftick_state = None
        self._ftick_plans = None
        self._ftick_goals = None
        self._ftick_n = 0
        self._ftick_last_time = 0.0
        self._tick_batch_fn = None
        self._rebuild()

    def _slot(self, msg: dict) -> dict:
        rid = str(msg.get("robot", ""))
        slot = self._slots.get(rid)
        if slot is None:
            # Creation is the only growth path, so eviction here bounds the
            # slot count: expire TTL-idle slots, then enforce the LRU cap
            # (leaving room for the new slot). An evicted robot that returns
            # simply starts from init_state — the same graceful degradation
            # as a reference server restart.
            now = self._slot_clock()
            if self.slot_ttl is not None:
                dead = [r for r, s in self._slots.items()
                        if now - s["last_used"] > self.slot_ttl]
                for r in dead:
                    del self._slots[r]
            while len(self._slots) >= self.max_slots:
                lru = min(self._slots, key=lambda r: self._slots[r]["last_used"])
                del self._slots[lru]
            slot = self._slots[rid] = {"state": init_state(self.cfg),
                                       "last_time": 0.0, "plan": None,
                                       "pending": None, "last_used": now}
        else:
            slot["last_used"] = self._slot_clock()
        return slot

    def op_release(self, msg: dict) -> dict:
        """Explicitly drop a robot's session slot (warm start, stuck clock,
        plan, pending result). A decommissioned/renamed robot should release
        its slot so a long-running server does not hold its device arrays
        until TTL/LRU eviction. {"op": "release", "robot": id}."""
        rid = str(msg.get("robot", ""))
        released = self._slots.pop(rid, None) is not None
        return {"ok": True, "released": released, "slots": len(self._slots)}

    # Default-slot views (tests / in-process callers address the single-robot
    # state directly; the default slot IS the reference's one server state).
    @property
    def state(self):
        return self._slot({})["state"]

    @state.setter
    def state(self, v) -> None:
        self._slot({})["state"] = v

    @property
    def last_time(self) -> float:
        return self._slot({})["last_time"]

    @last_time.setter
    def last_time(self, v: float) -> None:
        self._slot({})["last_time"] = v

    @property
    def _pending(self):
        return self._slot({})["pending"]

    @_pending.setter
    def _pending(self, v) -> None:
        self._slot({})["pending"] = v

    @property
    def _plan(self):
        return self._slot({})["plan"]

    @_plan.setter
    def _plan(self, v) -> None:
        self._slot({})["plan"] = v

    def _clear_pendings(self) -> None:
        for slot in self._slots.values():
            slot["pending"] = None
        self._fleet_pending = None

    def _fleet_pad(self, n: int) -> int:
        """Lane count for an n-robot fleet: next power of two >= max(4, n)
        (fleet-size churn reuses the executable), rounded up to a multiple of
        the visible device count so the sharded fleet path tiles the mesh."""
        pad = 4
        while pad < n:
            pad *= 2
        nd = jax.device_count()
        if pad % nd:
            pad = -(-pad // nd) * nd
        return pad

    def _chunked_dispatch(self, fn, lane_args, shared_args, lanes: int):
        """Run a fleet-batched fn over `lanes` lanes, split into sequential
        `fleet_chunk`-lane device dispatches when the batch divides evenly
        (kernel throughput peaks at 4096 lanes — see fleet_chunk). Each chunk
        has identical shapes, so every dispatch reuses ONE compiled
        executable; lanes are independent, so results are identical to the
        single-dispatch path. fn returns (packed, state_pytree)."""
        chunk = self.fleet_chunk
        nd = jax.device_count()
        if (chunk <= 0 or lanes <= chunk or lanes % chunk
                or (nd > 1 and chunk % nd)):
            return fn(*lane_args, *shared_args)
        packs, states = [], []
        for i in range(0, lanes, chunk):
            sl = slice(i, i + chunk)
            p, s = fn(*(jax.tree.map(lambda x: x[sl], a) for a in lane_args),
                      *shared_args)
            packs.append(p)
            states.append(s)
        return (jnp.concatenate(packs, axis=0),
                jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                             *states))

    @staticmethod
    def _fleet_jit(fn, sharded_args: int, total_args: int):
        """Compile a fleet-batched fn with the lane axis sharded over every
        visible device (round-3 verdict item 4: fleet ticks previously ran on
        ONE device no matter how many were visible). shard_map over a 1-D
        ('fleet',) mesh: each device runs the identical vmapped per-lane
        program on its local lanes — MPC lanes are independent, so no
        collective is introduced and per-lane results match the single-device
        path. The first `sharded_args` operands carry the lane axis; the rest
        (shared costmap/footprint/weights/limits) are replicated. On one
        device this is a plain jit."""
        n_dev = jax.device_count()
        if n_dev <= 1:
            return jax.jit(fn)
        from jax.sharding import Mesh, PartitionSpec as P

        mesh = Mesh(np.asarray(jax.devices()), ("fleet",))
        ax, rep = P("fleet"), P()
        specs = (ax,) * sharded_args + (rep,) * (total_args - sharded_args)
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=specs,
                                     out_specs=(ax, ax), check_vma=False))

    # Request vector layout (one host->device put per tick instead of seven,
    # each of which would be its own copy):
    # [pose(3), carrot(3), goal(3), vel(3), switch_opt, control_interval,
    #  delta_t] = 15 floats. Response vector: [cmd(3), converged, iters, fun,
    # collision, collision_footprint, local_plan((N+1)*3)] — ONE
    # device->host fetch per tick instead of ~7 serial per-field fetches.
    _REQ_W = 15

    @staticmethod
    def _pack_common(o) -> list:
        """Shared response-vector prefix [cmd(3), converged, iters, fun,
        collision, collision_footprint] = 8 slots — the ONE place the layout
        lives; _resp_from_vec is its decoder. op_tick appends its extra
        fields after this prefix."""
        f32 = o.cmd_vel.dtype
        flag = lambda x: x.astype(f32)[None]
        return [o.cmd_vel, flag(o.solver_converged), flag(o.solver_iters),
                flag(o.fun), flag(o.collision), flag(o.collision_footprint)]

    @staticmethod
    def _pack_tick_extras(o) -> list:
        """Full-tick extras appended after the _pack_common prefix:
        [lethal(8), plan_empty(9), carrot(10:13), window begin/end(13:15)].
        The ONE encode for both full-tick builders (single + batched);
        _tick_extras_from_vec is its decoder — keep them in lockstep."""
        f32 = o.cmd_vel.dtype
        flag = lambda x: x.astype(f32)[None]
        return [flag(o.lethal), flag(o.plan_empty), o.carrot_pose,
                flag(o.plan_window_begin), flag(o.plan_window_end)]

    @staticmethod
    def _tick_extras_from_vec(vec: np.ndarray) -> dict:
        return {
            "lethal": bool(vec[8] > 0.5),
            "plan_empty": bool(vec[9] > 0.5),
            "carrot_pose": vec[10:13].tolist(),
            "plan_window": [int(round(float(vec[13]))),
                            int(round(float(vec[14])))],
        }

    def _rebuild(self) -> None:
        cfg = self.cfg
        solver = make_sqp_solver(cfg, make_objective(cfg, parity=self.parity))
        pack_common = self._pack_common

        def pack_out(out):
            return jnp.concatenate(
                pack_common(out) + [out.local_plan.reshape(-1)])

        def one_req(st, rq, costmap, footprint, weights, limits):
            scen = Scenario(
                current_pose=rq[0:3], carrot_pose=rq[3:6], goal_pose=rq[6:9],
                current_vel=rq[9:12], footprint=footprint, costmap=costmap,
                switch_opt=rq[12] != 0, control_interval=rq[13],
                weights=weights, limits=limits)
            out = solve_step(cfg, st, scen, rq[14], solver=solver)
            return pack_out(out), out.state

        # Single-robot op routes through a batch-1 vmapped executable (same
        # treatment as MpcEngine.step): one program shape for the single and
        # the fleet paths. It was introduced for a compile-time pathology of
        # the unbatched scalar program on the engine's first backend; whether
        # a GPU still needs it is an open ROADMAP item.
        def step(state, req, costmap, footprint, weights, limits):
            packed, st = jax.vmap(
                lambda st1, rq: one_req(st1, rq, costmap, footprint,
                                        weights, limits)
            )(jax.tree.map(lambda x: x[None], state), req[None])
            return packed[0], jax.tree.map(lambda x: x[0], st)

        self._step = jax.jit(step)

        def fleet_step(state, reqs, costmap, footprint, weights, limits):
            # costmap/footprint/weights/limits are closed over per lane (NOT
            # vmapped and never returned), so the shared map is read in place
            # instead of being broadcast-materialized B times.
            return jax.vmap(
                lambda st1, rq: one_req(st1, rq, costmap, footprint,
                                        weights, limits))(state, reqs)

        # Fleet lanes shard over every visible device (shard_map; plain
        # jit on one device) — the serving x sharding composition.
        self._fleet_step = self._fleet_jit(fleet_step, 2, 6)
        self._tick_fn = None  # full-tick executables follow cfg; rebuild lazily
        self._tick_batch_fn = None
        # Weights/limits always travel as traced pytrees so runtime parameter
        # updates (RUNTIME_PARAMS) hit the same compiled executable.
        self._weights = Weights.from_config(cfg)
        self._limits = Limits.from_config(cfg)
        # Dynamic reconfigure keeps mission state when shapes allow — the
        # reference's cb_params (py:405-439) updates weights in place without
        # touching initial_guess/last_control/timers. Only a control_steps
        # change (resizing the warm start) forces a reset.
        for slot in self._slots.values():
            if (slot["state"] is None or slot["state"].initial_guess.shape[0]
                    != 3 * cfg.control_steps):
                slot["state"] = init_state(cfg)
                slot["pending"] = None
        if (self._fleet_state is not None
                and self._fleet_state.initial_guess.shape[-1]
                != 3 * cfg.control_steps):
            self._fleet_state = None
            self._fleet_pending = None
        if (self._ftick_state is not None
                and self._ftick_state.initial_guess.shape[-1]
                != 3 * cfg.control_steps):
            # control_steps resize: the staged batched-full-tick fleet must
            # be re-staged (lane states are shape-bound).
            self._ftick_state = None
            self._ftick_plans = None
            self._ftick_goals = None
            self._ftick_n = 0

    # ---- ops ----
    def op_configure(self, msg: dict) -> dict:
        # Merge over the current config: a partial reconfigure updates only
        # the named parameters (cb_params semantics, py:405-439) instead of
        # silently resetting the rest to defaults (ADVICE round-1).
        old_cfg = self.cfg
        params = msg.get("params", {})
        self.cfg = config_from_ros_params(params, base=self.cfg)
        if "pipelined" in msg:
            was = self.pipelined
            self.pipelined = bool(msg["pipelined"])
            if was != self.pipelined:
                # Mode toggle invalidates any in-flight result: re-enabling
                # pipelined mode must not serve a stale pre-toggle command
                # as "the previous tick" (round-3 review finding).
                self._clear_pendings()
        changed = {f.name for f in dataclasses.fields(MpcConfig)
                   if f.name != "compat"
                   and getattr(self.cfg, f.name) != getattr(old_cfg, f.name)}
        if changed <= RUNTIME_PARAMS:
            # Weight / bound update only: refresh the pytrees, keep the
            # compiled executable (the reference's in-place cb_params path —
            # and unlike its py:432-435 bug, w_costmap/w_footprint updates
            # actually take effect here).
            self._weights = Weights.from_config(self.cfg)
            self._limits = Limits.from_config(self.cfg)
            # Full-tick mode reads weights statically from cfg (the fused
            # pursuit tick builds its Scenario in-graph), so IT must rebuild
            # even on the otherwise retrace-free path.
            self._tick_fn = None
            self._tick_batch_fn = None
            return {"ok": True, "pipelined": self.pipelined, "retraced": False}
        # A shape-changing reconfigure invalidates any pipelined pending
        # result (its packed layout follows the OLD control_steps).
        self._clear_pendings()
        self._rebuild()
        if self.costmap is not None:
            # Re-derive the staged gather caches under the NEW cfg:
            # with_flat decides the u8 companion at STAGING time and
            # make_point_sampler prefers a cached u8 buffer whenever one is
            # present, so toggling solver_costmap_u8 at runtime would
            # otherwise silently keep sampling the old source until the next
            # full set_costmap (round-5 review).
            h, w = self.costmap.data.shape[-2], self.costmap.data.shape[-1]
            self.costmap = self.costmap.with_flat(
                u8=u8_source_enabled(self.cfg.solver_costmap_u8, h * w))
        return {"ok": True, "pipelined": self.pipelined, "retraced": True}

    def op_set_costmap(self, msg: dict) -> dict:
        """Stage the full costmap grid. Optional rolling-window view:
        "win_cells": N makes the solver see only the N×N window whose lower
        cell corner is "win_lo" [col, row] (default [0, 0]) — the zero-copy
        nav2 rolling local costmap. Incremental updates / window moves then
        ride op_set_costmap_update without re-sending the grid."""
        data = np.asarray(msg["data"], np.float32)
        if data.ndim != 2 or data.size == 0:
            return {"error": "costmap data must be a non-empty 2-D grid"}
        if not np.isfinite(data).all():
            # NaN/Inf policy (wire boundary): REJECT — a non-finite cell
            # would silently poison every objective it is gathered into.
            return {"error": "costmap data contains non-finite values"}
        cm = Costmap.create(
            data,
            origin=tuple(msg.get("origin", (0.0, 0.0))),
            resolution=float(msg.get("resolution", 0.05)),
        )
        h, w = cm.data.shape
        if "win_cells" in msg:
            wc = int(msg["win_cells"])
            lo = np.asarray(msg.get("win_lo", (0, 0)), np.int32)
            if not (0 < wc <= min(h, w)):
                return {"error": f"win_cells must be in [1, {min(h, w)}]"}
            if (lo.shape != (2,) or lo.min() < 0 or lo[0] + wc > w
                    or lo[1] + wc > h):
                return {"error": "win_lo puts the window outside the map"}
            cm = cm.replace(win_lo=jnp.asarray(lo), win_cells=wc)
        # Hoist the flat (and, per cfg, u8) gather views ONCE at staging so
        # per-tick executables read them as inputs instead of re-flattening
        # the grid in-graph every dispatch; update_window refreshes them
        # incrementally (the cache invariant at ops/costmap.py).
        self.costmap = cm.with_flat(
            u8=u8_source_enabled(self.cfg.solver_costmap_u8, h * w))
        self._ensure_footprint_sampling()
        return {"ok": True, "shape": [h, w]}

    def op_set_costmap_update(self, msg: dict) -> dict:
        """Incremental costmap update: write a dirty window of cells at
        "lo" [col, row] and/or move the rolling window ("win_lo") — without
        re-sending the whole grid (the reference's live Costmap2d keeps the
        map current behind every solve for free, mpc_optimization_server
        py:118 / NeoMpcPlanner.h:142-144; a per-tick full re-stage would
        move the whole grid). The staged flat/u8
        gather views refresh in place, so tick executables never retrace."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        cm = self.costmap
        h, w = cm.data.shape
        if "data" in msg:
            cells = np.asarray(msg["data"], np.float32)
            lo = np.asarray(msg.get("lo", (0, 0)), np.int32)
            if cells.ndim != 2 or cells.size == 0:
                return {"error": "update data must be a non-empty 2-D block"}
            if not np.isfinite(cells).all():
                # Same wire-boundary NaN/Inf policy as op_set_costmap: a
                # non-finite cell written into the staged map would poison
                # every later objective AND the persistent warm starts.
                return {"error": "update data contains non-finite values"}
            if (lo.shape != (2,) or lo.min() < 0 or lo[0] + cells.shape[1] > w
                    or lo[1] + cells.shape[0] > h):
                return {"error": "update window outside the map"}
            if self._update_fn is None:
                self._update_fn = jax.jit(
                    lambda c, b, l: c.update_window(b, l))
            cm = self._update_fn(cm, jnp.asarray(cells), jnp.asarray(lo))
        if "win_lo" in msg:
            if cm.win_cells is None:
                return {"error": "no rolling window configured "
                                 "(set_costmap with win_cells first)"}
            lo = np.asarray(msg["win_lo"], np.int32)
            wc = cm.win_cells
            if (lo.shape != (2,) or lo.min() < 0 or lo[0] + wc > w
                    or lo[1] + wc > h):
                return {"error": "win_lo puts the window outside the map"}
            cm = cm.replace(win_lo=jnp.asarray(lo))
        self.costmap = cm
        return {"ok": True}

    def op_set_footprint(self, msg: dict) -> dict:
        pts = np.asarray(msg["points"], np.float32)
        if pts.ndim != 2 or pts.shape[0] < 1 or pts.shape[1] != 2:
            return {"error": "footprint points must be a non-empty (V, 2) list"}
        if not np.isfinite(pts).all():
            return {"error": "footprint contains non-finite values"}
        self.footprint = Footprint.create(
            pts, max_vertices=self.cfg.max_footprint_vertices,
        )
        self._ensure_footprint_sampling()
        return {"ok": True}

    def _ensure_footprint_sampling(self) -> None:
        """Bump footprint_edge_samples so uniform sampling cannot skip cells
        (ceil(max_edge/resolution)+2; ADVICE round-1). No-op in exact mode."""
        if (self.cfg.footprint_exact or self.costmap is None
                or self.footprint is None):
            return
        from .ops.footprint import required_edge_samples

        nv = int(self.footprint.n_valid)
        need = required_edge_samples(
            np.asarray(self.footprint.vertices)[:nv],
            float(self.costmap.resolution))
        if need > self.cfg.footprint_edge_samples:
            self.cfg = self.cfg.replace(footprint_edge_samples=need)
            self._rebuild()

    def op_reset(self, msg: dict) -> dict:
        """New-mission reset: every robot slot (state, clock, PLAN, pending)
        plus the fleet lanes — the equivalent of restarting the reference's
        node. Clearing the plans matters: a tick after reset must error until
        the new mission's set_plan arrives, not drive toward the old goal
        (round-3 review finding)."""
        self._slots = {}
        self._fleet_state = None
        self._fleet_pending = None
        self._fleet_n = 0
        self._fleet_last_time = 0.0
        self._ftick_state = None
        self._ftick_plans = None
        self._ftick_goals = None
        self._ftick_n = 0
        self._ftick_last_time = 0.0
        return {"ok": True}

    def op_ping(self, msg: dict) -> dict:
        return {"ok": True, "backend": jax.default_backend(),
                "slots": len(self._slots)}

    def _checkpoint_path(self, msg: dict) -> str:
        """Resolve a request's checkpoint name inside checkpoint_dir. The
        request path is untrusted network input: relative, no '..', and ops
        are disabled entirely unless the server was configured with a
        directory (round-3 review: an unrestricted path is an arbitrary
        file write/read primitive over an unauthenticated socket)."""
        if self.checkpoint_dir is None:
            raise ValueError(
                "checkpoint ops disabled: configure the session/server "
                "with a checkpoint_dir")
        import os

        name = str(msg["path"])
        if os.path.isabs(name) or ".." in name.replace("\\", "/").split("/"):
            raise ValueError("checkpoint path must be relative without '..'")
        return os.path.join(self.checkpoint_dir, name)

    def op_save_state(self, msg: dict) -> dict:
        """Persist the warm-start/latch/timer state (checkpoint.py) — the
        state the reference loses on every server restart (SURVEY.md §5).
        {"op": "save_state", "path": p[, "fleet": true]}; p is a name under
        the server's checkpoint_dir (.npz file or orbax directory)."""
        from .checkpoint import save_state

        path = self._checkpoint_path(msg)
        if msg.get("fleet"):
            if self._fleet_state is None:
                return {"error": "no fleet state to save"}
            save_state(path, self._fleet_state)
            return {"ok": True, "fleet": True,
                    "lanes": int(self._fleet_state.initial_guess.shape[0]),
                    "robots": self._fleet_n}
        # Lookup WITHOUT _slot(): saving must not create a slot for a typo'd
        # robot id (which would both run LRU eviction against real robots and
        # silently checkpoint a fresh init_state instead of erroring).
        rid = str(msg.get("robot", ""))
        slot = self._slots.get(rid)
        if slot is None:
            return {"error": f"no session state for robot {rid!r} "
                             "(nothing solved yet?)"}
        slot["last_used"] = self._slot_clock()
        save_state(path, slot["state"])
        return {"ok": True, "fleet": False}

    def op_load_state(self, msg: dict) -> dict:
        """Restore a save_state checkpoint. Fleet restores adopt the stored
        lane pad (re-padded to a device multiple when the mesh changed);
        {"robots": n} sets the live robot count (default: every lane),
        clamped to [0, pad]. Shapes must match the current control_steps."""
        from .checkpoint import load_state

        path = self._checkpoint_path(msg)
        if msg.get("fleet"):
            st = load_state(path, template=self._fleet_state)
            if int(st.initial_guess.shape[-1]) != 3 * self.cfg.control_steps:
                return {"error": "checkpoint control_steps mismatch"}
            pad = int(st.initial_guess.shape[0])
            nd = jax.device_count()
            if pad % nd:
                # The sharded fleet path tiles lanes over the mesh; a
                # checkpoint saved under a different device count must be
                # re-padded to tile. Grow with init_state lanes (they are
                # recomputed from scratch on the next tick anyway).
                new_pad = self._fleet_pad(pad)
                fresh = jax.tree.map(
                    lambda x: jnp.broadcast_to(x, (new_pad,) + x.shape),
                    init_state(self.cfg))
                st = jax.tree.map(lambda f, o: f.at[:pad].set(o), fresh, st)
                pad = new_pad
            self._fleet_state = st
            self._fleet_n = max(0, min(int(msg.get("robots", pad)), pad))
            self._fleet_pending = None
            return {"ok": True, "fleet": True, "lanes": pad,
                    "robots": self._fleet_n}
        slot = self._slot(msg)
        st = load_state(path, template=slot["state"])
        if int(st.initial_guess.shape[-1]) != 3 * self.cfg.control_steps:
            return {"error": "checkpoint control_steps mismatch"}
        slot["state"] = st
        slot["pending"] = None
        return {"ok": True, "fleet": False}

    def _pack_req(self, msg: dict, delta_t: float) -> np.ndarray:
        req = np.zeros(self._REQ_W, np.float32)
        req[0:3] = np.asarray(msg["current_pose"], np.float32)
        req[3:6] = np.asarray(msg["carrot_pose"], np.float32)
        req[6:9] = np.asarray(msg["goal_pose"], np.float32)
        req[9:12] = np.asarray(msg["current_vel"], np.float32)
        req[12] = 1.0 if msg.get("switch_opt", False) else 0.0
        req[13] = float(msg.get("control_interval",
                                self.cfg.control_interval))
        req[14] = float(delta_t)
        if not np.isfinite(req).all():
            # NaN/Inf policy (wire boundary): reject rather than let a bad
            # pose poison the persistent warm-start state for every later
            # tick (handle() converts this to an error response).
            raise ValueError("request contains non-finite values")
        return req

    def _resp_from_vec(self, vec: np.ndarray, lp_off: int = 8) -> dict:
        """Decode the _pack_common prefix + the local plan at lp_off (8 for
        the optimizer ops; the full-tick vector carries extras in between)."""
        n = self.cfg.control_steps
        return {
            "output_vel": vec[:3].tolist(),
            "success": bool(vec[3] > 0.5),
            "iterations": int(round(float(vec[4]))),
            "cost": float(vec[5]),
            "collision": bool(vec[6] > 0.5),
            "collision_footprint": bool(vec[7] > 0.5),
            "local_plan": vec[lp_off:lp_off + 3 * (n + 1)]
                          .reshape(n + 1, 3).tolist(),
        }

    def _warmup_resp(self) -> dict:
        return {"output_vel": [0.0, 0.0, 0.0], "success": True,
                "iterations": 0, "cost": 0.0, "collision": False,
                "collision_footprint": False, "pipelined_warmup": True,
                "local_plan": np.zeros(
                    (self.cfg.control_steps + 1, 3)).tolist()}

    def op_optimizer(self, msg: dict) -> dict:
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            # Unlike the reference (which crashes if the footprint topic has
            # not arrived before the first solve — SURVEY.md §2.3.10), refuse
            # explicitly.
            return {"error": "no footprint set"}

        # Validate (pack) BEFORE touching the slot's stuck-timer clock: a
        # rejected request must not shrink the retry's measured delta_t
        # (round-5 review — same ordering as op_optimizer_batch).
        req = self._pack_req(msg, 0.0)  # one put, one fetch per tick
        slot = self._slot(msg)  # per-robot state/clock/pending
        if "delta_t" in msg:
            delta_t = float(msg["delta_t"])
            if not np.isfinite(delta_t):
                return {"error": "delta_t is not finite"}
        else:
            now = time.time()
            delta_t = now - slot["last_time"]
            slot["last_time"] = now
        req[14] = delta_t
        packed, slot["state"] = self._step(
            slot["state"], jnp.asarray(req), self.costmap, self.footprint,
            self._weights, self._limits)

        if self.pipelined:
            # Serve the previous tick's (already finished) result; the solve
            # dispatched above completes in the background on device.
            prev, slot["pending"] = slot["pending"], packed
            if prev is None:
                return self._warmup_resp()
            packed = prev

        return self._resp_from_vec(np.asarray(packed))

    # ---- full-tick mode (server-side pursuit + solve; no geometry on the
    # robot client at all) ----
    def op_set_plan(self, msg: dict) -> dict:
        """Stage the global plan for op_tick (setPlan, cpp:274-281): the
        consumed prefix resets; slow-down latches only on a GOAL CHANGE —
        a nav stack re-publishing the unchanged plan every replanning cycle
        must not knock the hysteresis back to the conservative lookahead
        (matches NeoMpcController.set_plan; round-3 review finding)."""
        from .ops.pursuit import Plan

        poses = np.asarray(msg["poses"], np.float32)
        if poses.ndim != 2 or poses.shape[0] < 1 or poses.shape[1] != 3:
            return {"error": "poses must be a non-empty (N, 3) list"}
        if poses.shape[0] > self.cfg.max_plan_points:
            return {"error": f"plan has {poses.shape[0]} poses > "
                             f"max_plan_points={self.cfg.max_plan_points}"}
        slot = self._slot(msg)
        new_plan = Plan.create(poses, max_points=self.cfg.max_plan_points)
        old = slot["plan"]
        goal_changed = (old is None or not np.array_equal(
            np.asarray(old.goal()), np.asarray(new_plan.goal())))
        slot["plan"] = new_plan
        st = slot["state"]
        slot["state"] = st.replace(
            plan_start=jnp.int32(0),
            slow_down=jnp.asarray(bool(goal_changed) or bool(st.slow_down)))
        return {"ok": True, "n_poses": int(poses.shape[0])}

    def _build_tick(self):
        from .engine import make_batched_controller_step

        cfg = self.cfg
        step = make_batched_controller_step(cfg, parity=self.parity)

        pack_common = self._pack_common

        def tickfn(state, plan, pose, vel, dt, costmap, footprint):
            args = jax.tree.map(lambda a: a[None],
                                (state, plan, pose, vel, costmap, footprint,
                                 dt))
            out = step(*args)
            o = jax.tree.map(lambda x: x[0], out)
            packed = jnp.concatenate(                     # 0:8 shared prefix
                pack_common(o) + self._pack_tick_extras(o)    # 8:15 extras
                + [o.local_plan.reshape(-1)])                 # 15:
            return packed, o.state

        self._tick_fn = jax.jit(tickfn)

    def op_tick(self, msg: dict) -> dict:
        """One FULL controller tick on device: pursuit geometry + solve +
        post-processing (the fused equivalent of both reference processes).
        Client sends {"pose": [x,y,yaw], "vel": [vx,vy,wz]} per tick; plugin
        gates come back as `lethal`/`plan_empty` flags (the in-process facade
        raises ControllerException for them, controller.py)."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            return {"error": "no footprint set"}
        slot = self._slot(msg)
        if slot["plan"] is None:
            return {"error": "no plan set (op set_plan first)"}
        pose = np.asarray(msg["pose"], np.float32)
        vel = np.asarray(msg["vel"], np.float32)
        if pose.shape != (3,) or vel.shape != (3,):
            # Validate BEFORE tracing: a short pose would raise IndexError
            # inside jit, which escapes handle()'s error net and kills the
            # connection (round-3 review finding).
            return {"error": "pose and vel must be [x, y, yaw]/[vx, vy, wz]"}
        if "delta_t" in msg:
            delta_t = float(msg["delta_t"])
        else:
            now = time.time()
            delta_t = now - slot["last_time"]
            slot["last_time"] = now
        if self._tick_fn is None:
            self._build_tick()
        packed, slot["state"] = self._tick_fn(
            slot["state"], slot["plan"],
            jnp.asarray(pose), jnp.asarray(vel),
            jnp.float32(delta_t), self.costmap, self.footprint)
        vec = np.asarray(packed)  # ONE fetch
        resp = self._resp_from_vec(vec, lp_off=15)
        resp.update(self._tick_extras_from_vec(vec))
        return resp

    def op_set_plans(self, msg: dict) -> dict:
        """Stage positional per-lane plans for op_tick_batch (the batched
        full-tick fleet: server-side pursuit + solve for N robots as ONE
        device dispatch). Plans are positional like optimizer_batch robots;
        lanes whose goal CHANGED (and new lanes) get the setPlan latch
        (prefix reset + slow-down, cpp:274-281); surviving same-goal lanes
        keep their hysteresis and warm state."""
        from .ops.pursuit import Plan

        raw = msg.get("plans", [])
        if not raw:
            return {"error": "empty plans list"}
        built = []
        for p in raw:
            poses = np.asarray(p, np.float32)
            if poses.ndim != 2 or poses.shape[0] < 1 or poses.shape[1] != 3:
                return {"error": "each plan must be a non-empty (N, 3) list"}
            if poses.shape[0] > self.cfg.max_plan_points:
                return {"error": f"a plan has {poses.shape[0]} poses > "
                                 f"max_plan_points={self.cfg.max_plan_points}"}
            built.append(Plan.create(poses,
                                     max_points=self.cfg.max_plan_points))
        n = len(built)
        pad = self._fleet_pad(n)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                               *(built + [built[0]] * (pad - n)))
        new_goals = np.stack([np.asarray(b.goal()) for b in built])

        fresh = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (pad,) + x.shape),
            init_state(self.cfg))
        old_st = self._ftick_state
        keep = (min(self._ftick_n, n, int(old_st.initial_guess.shape[0]))
                if old_st is not None else 0)
        st = (fresh if old_st is None else jax.tree.map(
            lambda f, o: f.at[:keep].set(o[:keep]), fresh, old_st))
        # Per-lane setPlan latch: goal changed (vs the previous staging) or
        # lane is new.
        changed = np.ones((pad,), bool)
        if self._ftick_goals is not None:
            k = min(keep, len(self._ftick_goals), n)
            changed[:k] = np.any(self._ftick_goals[:k] != new_goals[:k],
                                 axis=-1)
        st = st.replace(
            plan_start=jnp.zeros((pad,), jnp.int32),
            slow_down=st.slow_down | jnp.asarray(changed))
        self._ftick_state = st
        self._ftick_plans = stacked
        self._ftick_goals = new_goals
        self._ftick_n = n
        return {"ok": True, "n_plans": n, "lanes": pad}

    def _build_tick_batch(self):
        from .engine import controller_step

        cfg = self.cfg
        solver = make_sqp_solver(cfg, make_objective(cfg, parity=self.parity))
        pack_common = self._pack_common

        def fn(state, plans, reqs, costmap, footprint):
            # reqs: (B, 7) = [pose(3), vel(3), delta_t]. costmap/footprint
            # closed over (shared, read in place — not broadcast B times).
            def one(st, pl, rq):
                o = controller_step(cfg, st, pl, rq[0:3], rq[3:6], costmap,
                                    footprint, rq[6], solver=solver)
                packed = jnp.concatenate(
                    pack_common(o) + self._pack_tick_extras(o)
                    + [o.local_plan.reshape(-1)])
                return packed, o.state

            return jax.vmap(one)(state, plans, reqs)

        self._tick_batch_fn = self._fleet_jit(fn, 3, 5)

    def op_tick_batch(self, msg: dict) -> dict:
        """Batched full-tick fleet: {"op": "tick_batch", "robots":
        [{"pose": …, "vel": …}, …]} — robot count must match the staged
        op_set_plans count. One device dispatch runs pursuit + solve +
        post-processing for every lane; blocking (no pipelined variant)."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            return {"error": "no footprint set"}
        if self._ftick_plans is None:
            return {"error": "no plans staged (op set_plans first)"}
        robots = msg.get("robots", [])
        if len(robots) != self._ftick_n:
            return {"error": f"{len(robots)} robots != {self._ftick_n} "
                             f"staged plans (re-stage with set_plans)"}
        pad = int(self._ftick_state.initial_guess.shape[0])
        if "delta_t" in msg:
            delta_t = float(msg["delta_t"])
        else:
            now = time.time()
            delta_t = now - self._ftick_last_time
            self._ftick_last_time = now
        reqs = np.zeros((pad, 7), np.float32)
        reqs[:, 6] = delta_t
        for i, r in enumerate(robots):
            pose = np.asarray(r["pose"], np.float32)
            vel = np.asarray(r["vel"], np.float32)
            if pose.shape != (3,) or vel.shape != (3,):
                return {"error": "pose and vel must be "
                                 "[x, y, yaw]/[vx, vy, wz]"}
            reqs[i, 0:3] = pose
            reqs[i, 3:6] = vel
        if self._tick_batch_fn is None:
            self._build_tick_batch()
        packed, self._ftick_state = self._chunked_dispatch(
            self._tick_batch_fn,
            (self._ftick_state, self._ftick_plans, jnp.asarray(reqs)),
            (self.costmap, self.footprint), pad)
        vecs = np.asarray(packed)  # ONE batched fetch
        results = []
        for i in range(self._ftick_n):
            vec = vecs[i]
            resp = self._resp_from_vec(vec, lp_off=15)
            resp.update(self._tick_extras_from_vec(vec))
            results.append(resp)
        return {"results": results}

    def _resize_fleet(self, pad: int) -> None:
        """Grow/shrink the persistent lane state to `pad` lanes: lanes that
        held REAL robots (< _fleet_n) keep their warm starts/timers
        (positional identity); everything else starts from init_state — pad
        lanes are solved every tick too, so their evolved state must never
        be inherited by a robot (ADVICE round-2)."""
        fresh = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (pad,) + x.shape),
            init_state(self.cfg))
        old = self._fleet_state
        if old is None:
            self._fleet_state = fresh
            return
        keep = min(self._fleet_n, pad)
        self._fleet_state = jax.tree.map(
            lambda f, o: f.at[:keep].set(o[:keep]), fresh, old)
        # _fleet_pending is deliberately KEPT across a resize: surviving
        # lanes (< min(prev_n, n)) are positionally identical in the pending
        # packed array, whose old pad stays indexable for them. Clearing it
        # here made pipelined mode return all-warmup ZERO commands for the
        # whole fleet on every tick whenever per-tick fleet-size churn
        # crossed a pad boundary (4<->5 robots: pad 4<->8 resizes every
        # tick) — the round-2 warmup-starvation bug resurrected at pad
        # edges (round-5 review). _rebuild still clears it: a cfg change
        # alters the response layout itself.

    def op_optimizer_batch(self, msg: dict) -> dict:
        """Fleet tick: N robots sharing the staged costmap/footprint solved as
        one batched device dispatch. See the module docstring for semantics."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            return {"error": "no footprint set"}
        robots = msg.get("robots", [])
        n = len(robots)
        if n == 0:
            return {"error": "empty robots list"}
        # Pad the batch to a power of two (min 4, device-count multiple):
        # fleet-size churn then reuses the compiled executable instead of
        # retracing per size, and the lanes tile the device mesh.
        pad = self._fleet_pad(n)

        # VALIDATE (pack every request) before any persistent mutation: a
        # malformed robot must reject the whole request without advancing
        # the stuck-timer clock or resetting grown lanes (round-5 review —
        # a failed-then-retried request otherwise under-accumulates every
        # blocked robot's waiting_time). delta_t lands in slot 14 afterward.
        default_ci = msg.get("control_interval", self.cfg.control_interval)
        reqs = np.zeros((pad, self._REQ_W), np.float32)
        for i, r in enumerate(robots):
            reqs[i] = self._pack_req(
                {**r, "control_interval": r.get("control_interval",
                                                default_ci)}, 0.0)

        if (self._fleet_state is None
                or int(self._fleet_state.initial_guess.shape[0]) != pad):
            self._resize_fleet(pad)
        elif n > self._fleet_n:
            # Same pad, more robots: lanes [_fleet_n:) evolved as pad lanes
            # (or belonged to since-dropped robots) — reset them so the new
            # robots start from init_state.
            fresh = init_state(self.cfg)
            prev = self._fleet_n
            self._fleet_state = jax.tree.map(
                lambda s, f: s.at[prev:].set(
                    jnp.broadcast_to(f, (pad - prev,) + f.shape)),
                self._fleet_state, fresh)

        if "delta_t" in msg:
            delta_t = float(msg["delta_t"])
            if not np.isfinite(delta_t):
                return {"error": "delta_t is not finite"}
        else:
            now = time.time()
            delta_t = now - self._fleet_last_time
            self._fleet_last_time = now
        reqs[:, 14] = delta_t  # every lane (incl. pad) shares the tick clock

        packed, self._fleet_state = self._chunked_dispatch(
            self._fleet_step, (self._fleet_state, jnp.asarray(reqs)),
            (self.costmap, self.footprint, self._weights, self._limits), pad)
        self._fleet_n = n

        n_out = n
        if self.pipelined:
            prev, self._fleet_pending = self._fleet_pending, (packed, n)
            if prev is None:
                return {"results": [self._warmup_resp() for _ in range(n)]}
            # Fleet-size churn: surviving lanes (< min(prev_n, n)) get the
            # previous tick's real results; only NEW lanes get a warmup
            # entry (ADVICE round-2 — all-or-nothing warmup starved
            # every robot under per-tick churn). prev survives a resize too
            # (its packed array keeps the OLD pad, indexable for every
            # surviving lane — see _resize_fleet); only a cfg rebuild drops
            # it, because that changes the response layout.
            packed, prev_n = prev
            n_out = min(prev_n, n)

        # ONE batched host fetch, then slice off the pad lanes.
        vecs = np.asarray(packed)
        results = [self._resp_from_vec(vecs[i]) for i in range(n_out)]
        results += [self._warmup_resp() for _ in range(n - n_out)]
        return {"results": results}

    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            return {"error": f"unknown op: {op!r}"}
        try:
            return fn(msg)
        except Exception as e:  # noqa: BLE001 — the error NET is the contract
            # Every op failure must come back as {"error": ...} on the same
            # connection: an escaping exception kills the handler thread and
            # the client sees a bare ConnectionError instead of the cause
            # (round-5 review: checkpoint-op filesystem errors — missing
            # file, unwritable subdir, absent orbax — fell outside the old
            # (KeyError, TypeError, ValueError) tuple). Non-Exception exits
            # (KeyboardInterrupt/SystemExit) still propagate.
            return {"error": f"{type(e).__name__}: {e}"}


def serve(host: str = "127.0.0.1", port: int = 7180,
          cfg: Optional[MpcConfig] = None, ready_event=None,
          pipelined: bool = False,
          checkpoint_dir: Optional[str] = None, max_slots: int = 1024,
          slot_ttl: Optional[float] = None, parity: bool = True,
          fleet_chunk: int = 4096) -> None:
    """Blocking server loop (ros2 run … mpc_optimization_server equivalent,
    README.md:92). checkpoint_dir enables the save_state/load_state ops,
    confined to that directory.

    Connections are threaded but REQUESTS serialize on one lock — the same
    discipline as the reference's single-threaded rclpy executor (py:441-444)
    with any number of service clients: N robot processes can stay connected
    simultaneously (a plain TCPServer would park client 2 until client 1
    disconnected), while the session state and the device see
    strictly ordered requests."""
    import threading

    session = OptimizerSession(cfg, pipelined=pipelined,
                               checkpoint_dir=checkpoint_dir,
                               max_slots=max_slots, slot_ttl=slot_ttl,
                               parity=parity, fleet_chunk=fleet_chunk)
    lock = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"error": f"bad json: {e}"}
                else:
                    with lock:
                        resp = session.handle(msg)
                self.wfile.write(json.dumps(resp).encode() + b"\n")
                self.wfile.flush()

    class Server(socketserver.ThreadingMixIn, socketserver.TCPServer):
        allow_reuse_address = True  # must be set before bind
        daemon_threads = True

    with Server((host, port), Handler) as srv:
        if ready_event is not None:
            ready_event.set()
        srv.serve_forever()


def _json_default(o):
    """json.dumps fallback: ops composed from the translation helpers
    (ros_adapter's occupancy_grid_*/costmap_refresh_op) carry numpy arrays
    in "data" — encode them as nested lists so the documented
    translate-then-OptimizerClient composition works over the wire. Anything
    else raises the standard TypeError naming the offending type (not the
    opaque AttributeError a bare `o.tolist()` would)."""
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} "
                    "is not JSON serializable")


class OptimizerClient:
    """Minimal blocking client — the stand-in for the plugin's service client
    (NeoMpcPlanner.cpp:308, :248-250), with the same wait-for-service loop
    semantics (cpp:325-330)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7180,
                 wait_timeout: float = 10.0):
        deadline = time.time() + wait_timeout
        while True:
            try:
                self.sock = socket.create_connection((host, port), timeout=1.0)
                # Solve calls block like the plugin's result.get() (cpp:250);
                # the first one includes jit compilation.
                self.sock.settimeout(None)
                break
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError("optimizer service not available")
                time.sleep(0.2)
        self.f = self.sock.makefile("rwb")

    def call(self, msg: dict) -> dict:
        self.f.write(json.dumps(msg, default=_json_default).encode() + b"\n")
        self.f.flush()
        line = self.f.readline()
        if not line:
            raise ConnectionError("server closed connection")
        return json.loads(line)

    def close(self) -> None:
        self.f.close()
        self.sock.close()
