"""Solver tests: projection/prox operators against scipy ground truth, and the
SQP solver against the scipy SLSQP oracle (SURVEY.md §4 oracle strategy).

Parity criterion: at tight tolerance both solvers should land on the same KKT
point on well-conditioned scenarios (raw-x match); on adversarial scenarios the
objective is nearly flat along some directions, so the meaningful assertion is
that our final objective is never worse than scipy's beyond tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.optimize import minimize

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.oracle import NpCostmap, NpScenario, OracleServer
from neo_mpc_planner2_tpu.solver import prox_g
from neo_mpc_planner2_tpu.ops.objective import control_cost


def _scipy_project(z, cfg):
    """Ground-truth projection onto box ∩ disk via scipy."""
    n = cfg.control_steps
    bnds, cons = [], []
    for i in range(n):
        bnds += [(cfg.min_vel_x, cfg.max_vel_x), (cfg.min_vel_y, cfg.max_vel_y),
                 (cfg.min_vel_theta, cfg.max_vel_theta)]
        cons.append({"type": "ineq",
                     "fun": lambda u, i=i: cfg.max_vel_trans
                     - np.sqrt(u[3 * i] ** 2 + u[3 * i + 1] ** 2)})
    r = minimize(lambda u: 0.5 * np.sum((u - z) ** 2), np.clip(z, -10, 10),
                 method="SLSQP", bounds=bnds, constraints=cons,
                 options={"ftol": 1e-12})
    return r.x


class TestProjection:
    def test_interior_point_unchanged(self, cfg):
        z = jnp.asarray(np.full(9, 0.1), jnp.float32)
        np.testing.assert_allclose(mpc.project_feasible(z, cfg), z, atol=1e-6)

    def test_matches_scipy(self, cfg):
        rng = np.random.default_rng(3)
        for _ in range(5):
            z = rng.uniform(-2, 2, 9)
            got = mpc.project_feasible(jnp.asarray(z, jnp.float32), cfg)
            want = _scipy_project(z, cfg)
            np.testing.assert_allclose(got, want, atol=2e-4)

    def test_respects_disk(self, cfg):
        z = jnp.asarray([5.0, 5.0, 0.0] * 3, jnp.float32)
        p = np.asarray(mpc.project_feasible(z, cfg)).reshape(3, 3)
        for row in p:
            assert np.hypot(row[0], row[1]) <= cfg.max_vel_trans + 1e-5

    def test_box_bound_exceeding_radius(self, cfg):
        """Regression (round-5 review): with a box bound OUTSIDE the disk
        (forward-fast, sideways-slow omni config), the circle-edge candidate
        fabricated by sqrt(max(r²−coord², 0))=0 lies off the disk and used to
        be returned — a 'projection' violating max_vel_trans. Checked against
        scipy on the same feasibility set."""
        c = cfg.replace(min_vel_x=-1.0, max_vel_x=1.0,
                        min_vel_y=-0.1, max_vel_y=0.1, max_vel_trans=0.5)
        z = np.array([0.9, 0.3, 0.0] * 3)
        got = np.asarray(mpc.project_feasible(
            jnp.asarray(z, jnp.float32), c)).reshape(3, 3)
        for row in got:
            assert np.hypot(row[0], row[1]) <= c.max_vel_trans + 1e-5
        np.testing.assert_allclose(got.reshape(-1), _scipy_project(z, c),
                                   atol=2e-4)


class TestProxG:
    def test_matches_scipy_prox(self, cfg):
        """prox of tau·Σ‖u_i − v‖ + indicator vs scipy on the same problem."""
        rng = np.random.default_rng(5)
        v = np.array([0.5, 0.2, 0.1])
        for tau in [0.01, 0.1, 0.5]:
            z = rng.uniform(-1.5, 1.5, 9)
            got = prox_g(jnp.asarray(z, jnp.float32), jnp.float32(tau),
                         jnp.asarray(v, jnp.float32), cfg)
            n = cfg.control_steps
            bnds, cons = [], []
            for i in range(n):
                bnds += [(cfg.min_vel_x, cfg.max_vel_x),
                         (cfg.min_vel_y, cfg.max_vel_y),
                         (cfg.min_vel_theta, cfg.max_vel_theta)]
                cons.append({"type": "ineq",
                             "fun": lambda u, i=i: cfg.max_vel_trans
                             - np.sqrt(u[3 * i] ** 2 + u[3 * i + 1] ** 2)})
            obj = lambda u: 0.5 * np.sum((u - z) ** 2) + tau * sum(
                np.linalg.norm(u[3 * i:3 * i + 3] - v) for i in range(n))
            want = minimize(obj, np.zeros(9), method="SLSQP", bounds=bnds,
                            constraints=cons, options={"ftol": 1e-12}).x
            np.testing.assert_allclose(got, want, atol=3e-3)


def _curated_cases():
    return [
        ([0.0, 0.0, 0.0], [0.4, 0.1, 0.2], [1.0, 0.5, 0.3]),
        ([0.3, 0.0, 0.0], [0.4, 0.1, 0.2], [1.0, 0.5, 0.3]),
        ([0.5, 0.2, 0.1], [0.6, -0.2, -0.4], [1.5, -0.5, -0.6]),
        ([0.2, 0.1, 0.0], [0.05, 0.02, 0.0], [0.1, 0.05, 0.0]),
        ([0.0, 0.0, 0.5], [0.1, 0.5, 1.2], [0.5, 1.0, 1.5]),
        ([-0.4, 0.3, -0.2], [-0.5, 0.4, 0.9], [-1.0, 1.0, 1.2]),
    ]


class TestSqpVsOracle:
    @pytest.fixture(scope="class")
    def tight_cfg(self, cfg):
        return cfg.replace(opt_tolerance=1e-8)

    @pytest.fixture(scope="class")
    def solver(self, tight_cfg):
        return jax.jit(mpc.make_sqp_solver(
            tight_cfg, mpc.make_objective(tight_cfg), ftol=1e-8, max_iters=300))

    def test_curated_commands_match(self, tight_cfg, solver, empty_costmap,
                                    footprint, footprint_np):
        npcm = NpCostmap(np.zeros((40, 40)), np.array([-1.0, -1.0]), 0.05)
        for vel, carrot, goal in _curated_cases():
            scen = mpc.Scenario.create([0.0, 0.0, 0.0], carrot, goal, vel,
                                       footprint, empty_costmap)
            res = solver(jnp.zeros(9), scen)
            nps = NpScenario(np.zeros(3), np.array(carrot), np.array(goal),
                             np.array(vel), footprint_np, npcm)
            srv = OracleServer(tight_cfg)
            _, diag = srv.solve(nps, 0.033)
            dx = np.abs(diag["raw"] - np.asarray(res.x)).max()
            fgap = float(res.fun) - diag["fun"]
            # Same KKT point within a few×1e-3 (scipy's own finite-difference
            # accuracy floor). When scipy stops short of the optimum (its FD
            # gradients limit it near active cone constraints) our solution may
            # differ more — acceptable iff the objectives tie. The tie
            # threshold is the float32 noise floor of the accumulated
            # objective at ftol=1e-8 (far below f32 resolution): each eval
            # carries ~1e-6-level rounding from the fused term sums, so a
            # ≲1e-5 gap is a stopped-one-rounding-step-earlier artifact,
            # not a different basin. Both gates stay far inside the
            # reference's own opt_tolerance (1e-3 sample / 1e-5 default).
            assert dx < 5e-3 or fgap < 1e-5, (vel, carrot, goal, dx, fgap)
            # Never meaningfully worse in objective.
            assert fgap < 1e-4, (vel, carrot, goal, fgap)

    def test_never_worse_randomized(self, tight_cfg, solver, empty_costmap,
                                    footprint, footprint_np):
        rng = np.random.default_rng(7)
        npcm = NpCostmap(np.zeros((40, 40)), np.array([-1.0, -1.0]), 0.05)
        worse = 0
        for _ in range(15):
            vel = rng.uniform(-0.7, 0.7, 3)
            carrot = rng.uniform(-0.8, 0.8, 3) * np.array([1, 1, 2.5])
            goal = rng.uniform(-1.2, 1.2, 3) * np.array([1, 1, 2.5])
            cur = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                            rng.uniform(-3, 3)])
            warm = rng.uniform(-0.5, 0.5, 9)
            scen = mpc.Scenario.create(cur, carrot, goal, vel, footprint,
                                       empty_costmap)
            res = solver(jnp.asarray(warm, jnp.float32), scen)
            nps = NpScenario(cur, carrot, goal, vel, footprint_np, npcm)
            srv = OracleServer(tight_cfg)
            srv.initial_guess = warm.copy()
            srv.old_goal = goal.copy()
            _, diag = srv.solve(nps, 0.033)
            if float(res.fun) > diag["fun"] + 2e-4:
                worse += 1
        assert worse == 0

    def test_solution_feasible(self, tight_cfg, solver, empty_costmap, footprint):
        scen = mpc.Scenario.create([0, 0, 0], [0.9, 0.9, 1.5], [2, 2, 1.5],
                                   [0.7, 0.7, 0.7], footprint, empty_costmap)
        res = solver(jnp.zeros(9), scen)
        u = np.asarray(res.x).reshape(3, 3)
        assert np.all(u[:, 0] <= tight_cfg.max_vel_x + 1e-4)
        assert np.all(u[:, 2] >= tight_cfg.min_vel_theta - 1e-4)
        for row in u:
            assert np.hypot(row[0], row[1]) <= tight_cfg.max_vel_trans + 1e-3


class TestProxFista:
    def test_smooth_quadratic(self, cfg):
        target = jnp.asarray([0.2, -0.1, 0.3] * 3, jnp.float32)
        f = lambda u: jnp.sum((u - target) ** 2)
        g = lambda u: jnp.zeros((), jnp.float32)
        res = mpc.prox_fista(f, g, jnp.float32(0.0), jnp.zeros(3), jnp.zeros(9),
                             cfg, ftol=1e-10, max_iters=500)
        np.testing.assert_allclose(res.x, target, atol=1e-4)
        assert bool(res.converged)

    def test_kink_is_fixed_point(self, cfg):
        """With a dominant control term the current velocity is the optimum
        (the SLSQP behavior on the same problem: stay at the kink)."""
        v = jnp.asarray([0.1, 0.05, 0.0], jnp.float32)
        lam = 1.0
        f = lambda u: 1e-3 * jnp.sum(u**2)
        g = lambda u: lam * jnp.sum(
            jnp.sqrt(jnp.sum((u.reshape(3, 3) - v) ** 2, axis=-1) + 1e-30))
        res = mpc.prox_fista(f, g, jnp.float32(lam), v, jnp.tile(v, 3), cfg,
                             ftol=1e-10, max_iters=200)
        np.testing.assert_allclose(res.x.reshape(3, 3), np.tile(v, (3, 1)),
                                   atol=1e-3)


class TestCholInverse:
    def test_matches_numpy_inverse(self):
        from neo_mpc_planner2_tpu.sqp import _chol_inverse

        rng = np.random.default_rng(11)
        for _ in range(10):
            A = rng.normal(size=(9, 9))
            M = A @ A.T + np.eye(9) * rng.uniform(0.5, 2.0)  # SPD
            got = np.asarray(_chol_inverse(jnp.asarray(M, jnp.float32)))
            want = np.linalg.inv(M)
            assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()

    def test_batched_and_vmapped(self):
        from neo_mpc_planner2_tpu.sqp import _chol_inverse

        rng = np.random.default_rng(12)
        A = rng.normal(size=(16, 9, 9))
        M = (A @ np.swapaxes(A, -1, -2) + np.eye(9)).astype(np.float32)
        got = np.asarray(_chol_inverse(jnp.asarray(M)))
        err = np.abs(got @ M - np.eye(9)).max()
        assert err < 2e-4
        got_v = np.asarray(jax.vmap(_chol_inverse)(jnp.asarray(M)))
        np.testing.assert_allclose(got_v, got, atol=1e-6)

    def test_ill_conditioned(self):
        from neo_mpc_planner2_tpu.sqp import _chol_inverse

        d = np.diag([1e4, 1e3, 1e2, 10, 1, 1, 0.1, 0.01, 1e-3]).astype(np.float32)
        got = np.asarray(_chol_inverse(jnp.asarray(d)))
        np.testing.assert_allclose(np.diag(got), 1.0 / np.diag(d), rtol=1e-4)

    def test_pallas_kernel_interpret(self):
        """The batched inverse (the custom_vmap rule's lane-minor XLA path,
        which the batched QP uses) against numpy at the batch and matrix
        sizes the former lane-block kernel was checked at: a batch that is
        not a multiple of a lane block, a larger one, and m=6
        (control_steps=2)."""
        from neo_mpc_planner2_tpu.sqp import _chol_inverse

        rng = np.random.default_rng(13)
        for B, m in ((37, 9), (300, 9), (16, 6)):
            A = rng.normal(size=(B, m, m))
            M = (A @ np.swapaxes(A, -1, -2)
                 + np.eye(m) * 2.0).astype(np.float32)
            got = np.asarray(jax.vmap(_chol_inverse)(jnp.asarray(M)))
            want = np.linalg.inv(M)
            assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()

    def test_vmap_rule_matches_primal_large_batch(self):
        """The custom_vmap rule (the lane-minor XLA path) agrees with the
        per-lane primal at a fleet-sized batch."""
        from neo_mpc_planner2_tpu.sqp import _chol_inverse

        rng = np.random.default_rng(14)
        A = rng.normal(size=(300, 9, 9))
        M = (A @ np.swapaxes(A, -1, -2) + np.eye(9)).astype(np.float32)
        got_v = np.asarray(jax.vmap(_chol_inverse)(jnp.asarray(M)))
        want = np.stack([np.asarray(_chol_inverse(jnp.asarray(M[i])))
                         for i in range(0, 300, 50)])
        np.testing.assert_allclose(got_v[::50], want, atol=1e-6)


def test_parallel_line_search_identical(cfg, empty_costmap, footprint):
    """cfg.parallel_line_search evaluates the same candidate steps in one
    fused wave — solutions must be bit-identical to sequential backtracking."""
    tight = cfg.replace(opt_tolerance=1e-8)
    scen = mpc.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], [1.0, 0.5, 0.3],
                               [0.3, 0.1, 0.05], footprint, empty_costmap)
    rng = np.random.default_rng(4)
    # jit once, reuse across starts (re-tracing per start dominated runtime).
    solve_seq = jax.jit(mpc.make_sqp_solver(tight, mpc.make_objective(tight),
                                            ftol=1e-8, max_iters=200,
                                            parallel_ls=False))
    solve_par = jax.jit(mpc.make_sqp_solver(tight, mpc.make_objective(tight),
                                            ftol=1e-8, max_iters=200,
                                            parallel_ls=True))
    for _ in range(5):
        x0 = jnp.asarray(rng.uniform(-0.5, 0.5, 9), jnp.float32)
        seq = solve_seq(x0, scen)
        par = solve_par(x0, scen)
        np.testing.assert_array_equal(np.asarray(seq.x), np.asarray(par.x))
        assert int(seq.iters) == int(par.iters)


def test_two_phase_schedule_branches_identical(cfg, empty_costmap, footprint):
    """The two-phase Armijo schedule (fine 0.5 grid for the first trips,
    coarse factor below) must select identical alphas in every line-search
    implementation: sequential halving, the parallel all-candidate wave, and
    the K-wide wave. Per-step alpha selection is exact; the carried objective
    value f fuses ~1 ulp differently per branch (each branch's merit
    evaluation is its own fused computation), which can shift a termination
    tie by one iteration — so solutions are compared to float noise, not
    bitwise."""
    two = cfg.replace(opt_tolerance=1e-8, solver_ls_coarse_after=2,
                      solver_ls_coarse_factor=0.0625,
                      solver_max_backtracks=7)
    scen = mpc.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], [1.0, 0.5, 0.3],
                               [0.3, 0.1, 0.05], footprint, empty_costmap)
    rng = np.random.default_rng(7)
    solve_seq = jax.jit(mpc.make_sqp_solver(two, mpc.make_objective(two),
                                            ftol=1e-8, max_iters=200,
                                            parallel_ls=False))
    solve_par = jax.jit(mpc.make_sqp_solver(two, mpc.make_objective(two),
                                            ftol=1e-8, max_iters=200,
                                            parallel_ls=True))
    solve_wave = jax.jit(mpc.make_sqp_solver(
        two.replace(solver_ls_wave=3), mpc.make_objective(two),
        ftol=1e-8, max_iters=200, parallel_ls=False))
    for _ in range(3):
        x0 = jnp.asarray(rng.uniform(-0.5, 0.5, 9), jnp.float32)
        seq = solve_seq(x0, scen)
        par = solve_par(x0, scen)
        wave = solve_wave(x0, scen)
        np.testing.assert_allclose(np.asarray(seq.x), np.asarray(par.x),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(seq.x), np.asarray(wave.x),
                                   rtol=1e-5, atol=1e-6)
        assert abs(int(seq.iters) - int(par.iters)) <= 1
        assert abs(int(seq.iters) - int(wave.iters)) <= 1


def test_two_phase_schedule_solution_quality(cfg, empty_costmap, footprint):
    """Coarsening only the deep backtracking tail must not degrade the
    converged objective: the two-phase solve lands within opt_tolerance of
    the single-phase solve's objective on random starts."""
    base = cfg.replace(opt_tolerance=1e-6)
    two = base.replace(solver_ls_coarse_after=2,
                       solver_ls_coarse_factor=0.0625,
                       solver_max_backtracks=7)
    scen = mpc.Scenario.create([0.1, -0.2, 0.3], [0.5, -0.1, 0.1],
                               [1.0, 0.5, 0.3], [0.2, 0.0, 0.1],
                               footprint, empty_costmap)
    f_obj = mpc.make_objective(base)
    rng = np.random.default_rng(11)
    solve_a = jax.jit(mpc.make_sqp_solver(base, f_obj, max_iters=100))
    solve_b = jax.jit(mpc.make_sqp_solver(two, f_obj, max_iters=100))
    for _ in range(5):
        x0 = jnp.asarray(rng.uniform(-0.5, 0.5, 9), jnp.float32)
        a = solve_a(x0, scen)
        b = solve_b(x0, scen)
        assert float(b.fun) <= float(a.fun) + 1e-4


def test_warm_alpha_schedule(cfg, empty_costmap, footprint):
    """solver_ls_warm_alpha: sequential/parallel/wave branches stay mutually
    consistent (same per-lane warm initial candidate), and solution quality
    holds vs the default cold-start schedule."""
    warm = cfg.replace(opt_tolerance=1e-6, solver_ls_warm_alpha=True)
    scen = mpc.Scenario.create([0.1, -0.2, 0.3], [0.5, -0.1, 0.1],
                               [1.0, 0.5, 0.3], [0.2, 0.0, 0.1],
                               footprint, empty_costmap)
    f_obj = mpc.make_objective(warm)
    rng = np.random.default_rng(17)
    solve_seq = jax.jit(mpc.make_sqp_solver(warm, f_obj, max_iters=100,
                                            parallel_ls=False))
    solve_par = jax.jit(mpc.make_sqp_solver(warm, f_obj, max_iters=100,
                                            parallel_ls=True))
    solve_wave = jax.jit(mpc.make_sqp_solver(warm.replace(solver_ls_wave=2),
                                             f_obj, max_iters=100,
                                             parallel_ls=False))
    solve_cold = jax.jit(mpc.make_sqp_solver(cfg.replace(opt_tolerance=1e-6),
                                             f_obj, max_iters=100))
    for _ in range(3):
        x0 = jnp.asarray(rng.uniform(-0.5, 0.5, 9), jnp.float32)
        seq = solve_seq(x0, scen)
        par = solve_par(x0, scen)
        wave = solve_wave(x0, scen)
        np.testing.assert_allclose(np.asarray(seq.x), np.asarray(par.x),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(seq.x), np.asarray(wave.x),
                                   rtol=1e-5, atol=1e-6)
        cold = solve_cold(x0, scen)
        assert float(seq.fun) <= float(cold.fun) + 1e-4


def test_quad_interp_line_search_converges(cfg, footprint):
    """solver_ls_quad_interp (round-4 eval-count lever): same minimizer class
    as the fixed schedule — commands stay within the fidelity envelope on a
    smooth scenario, the solver converges, and iterate counts stay bounded.
    (Its throughput at the fleet operating point is a device measurement;
    this pins CPU correctness.)"""
    import neo_mpc_planner2_tpu as mpc

    data = np.zeros((40, 40))
    data[25:30, 20:26] = 0.6
    cm = mpc.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05)
    scen = mpc.Scenario.create([0, 0, 0], [0.5, 0.1, 0.2], [1, 0.3, 0.2],
                               [0.2, 0, 0], footprint, cm)
    base = mpc.make_sqp_solver(cfg, mpc.make_objective(cfg), ftol=1e-8,
                               max_iters=100)
    qcfg = cfg.replace(solver_ls_quad_interp=True)
    quad = mpc.make_sqp_solver(qcfg, mpc.make_objective(qcfg), ftol=1e-8,
                               max_iters=100)
    x0 = jnp.zeros(3 * cfg.control_steps)
    rb = base(x0, scen)
    rq = quad(x0, scen)
    assert bool(rq.converged)
    # Same minimum within the smooth-scenario envelope.
    np.testing.assert_allclose(np.asarray(rq.x), np.asarray(rb.x), atol=5e-3)
    assert abs(float(rq.fun) - float(rb.fun)) < 1e-5
