"""Kernel-path tests on the CPU.

- The XLA one-hot footprint sampler must match the gather path bit-for-bit.
- The fused Pallas-Triton QP kernel (sqp._qp_admm_triton), run in interpret
  mode, must match the plain XLA QP, and the batched solve must choose it
  only when compiling for a CUDA GPU.
- On a GPU (marker `gpu`), the compiled kernel against the plain path.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops.footprint import footprint_cost, transform_footprint


def _batch(rng, B=4, H=64, W=128, lethal=False):
    data = rng.uniform(0, 0.95, (B, H, W)).astype(np.float32)
    if lethal:
        data[:, H // 2, :] = 1.0
    cm = mpc.Costmap(
        data=jnp.asarray(data),
        origin=jnp.tile(jnp.asarray([-1.6, -1.6], jnp.float32), (B, 1)),
        resolution=jnp.full((B,), 0.05, jnp.float32),
    )
    fp1 = mpc.Footprint.rectangle(0.63, 0.41)
    fps = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), fp1)
    poses = jnp.asarray(rng.uniform(-0.3, 0.3, (B, 3)), jnp.float32)
    placed = jax.vmap(transform_footprint)(poses, fps)
    return cm, placed


def _onehot_and_gather(cm, fp):
    cost = lambda mode: jax.vmap(
        lambda c, f: footprint_cost(c, f, 16, mode=mode))(cm, fp)
    return np.asarray(cost("onehot")), np.asarray(cost("gather"))


@pytest.mark.parametrize("lethal", [False, True])
def test_matches_gather_path(lethal):
    rng = np.random.default_rng(3 + lethal)
    got, want = _onehot_and_gather(*_batch(rng, lethal=lethal))
    np.testing.assert_array_equal(got, want)


def test_triangle_padding():
    rng = np.random.default_rng(7)
    B = 3
    data = rng.uniform(0, 0.9, (B, 64, 128)).astype(np.float32)
    cm = mpc.Costmap(data=jnp.asarray(data),
                     origin=jnp.tile(jnp.asarray([-1.6, -1.6], jnp.float32), (B, 1)),
                     resolution=jnp.full((B,), 0.05, jnp.float32))
    tri = mpc.Footprint.create([[0.21, 0.11], [-0.19, 0.11], [0.01, -0.16]],
                               max_vertices=8)
    tris = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), tri)
    got, want = _onehot_and_gather(cm, tris)
    np.testing.assert_array_equal(got, want)


def test_out_of_bounds_lethal():
    B = 2
    cm = mpc.Costmap(data=jnp.zeros((B, 64, 128), jnp.float32),
                     origin=jnp.tile(jnp.asarray([-1.6, -1.6], jnp.float32), (B, 1)),
                     resolution=jnp.full((B,), 0.05, jnp.float32))
    fp1 = mpc.Footprint.rectangle(0.6, 0.4)
    fps = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), fp1)
    poses = jnp.asarray([[10.0, 10.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
    placed = jax.vmap(transform_footprint)(poses, fps)
    got, want = _onehot_and_gather(cm, placed)
    assert float(got[0]) == 1.0
    assert float(got[1]) == 0.0
    np.testing.assert_array_equal(got, want)


def _qp_inputs(rng, B, m=9):
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
    hi = np.full((B, m), 0.7, np.float32)
    carry = tuple(rng.normal(size=(B, r)).astype(np.float32) * 0.1
                  for r in (m, m, n, m, n))
    return (jnp.asarray(Bmat.reshape(B, m * m)), jnp.asarray(g),
            jnp.asarray(x), jnp.asarray(c), jnp.asarray(J),
            jnp.asarray(lo), jnp.asarray(hi),
            *(jnp.asarray(a) for a in carry))


def _kernel_vs_plain(args, interpret=True, **kw):
    from neo_mpc_planner2_tpu.sqp import _qp_admm_plain, _qp_admm_triton

    qp = dict(iters=6, rho=1.0, sigma=1e-6)
    want = jax.vmap(partial(_qp_admm_plain, **qp))(*args)
    n = args[3].shape[-1]
    Jm = args[4]
    dxy = jnp.stack([Jm[:, k, 3 * k + a] for k in range(n)
                     for a in (0, 1)], axis=-1)
    got = _qp_admm_triton(*args[:4], dxy, *args[5:], **qp,
                          interpret=interpret, **kw)
    return got, want


class TestQpAdmmKernel:
    """The fused QP kernel (Cholesky factor + ADMM loop, sqp._qp_admm_kernel) in
    interpret mode must match the XLA scan path to float-reassociation
    noise, including on padded (non-multiple-of-block) batch tails and
    warm-started carries."""

    @pytest.mark.parametrize("B", [8, 131])
    def test_matches_plain(self, B):
        rng = np.random.default_rng(21 + B)
        got, want = _kernel_vs_plain(_qp_inputs(rng, B))
        for w, gt in zip(want, got):
            np.testing.assert_allclose(np.asarray(gt), np.asarray(w),
                                       rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("B,block", [(20, 32), (45, 32), (70, 64)])
    def test_m15_padded(self, B, block):
        """m=15 (control_steps=5) at batches that do not fill the last
        program: the wrapper pads with zero lanes and slices them off."""
        rng = np.random.default_rng(B)
        got, want = _kernel_vs_plain(_qp_inputs(rng, B, m=15), block=block)
        assert [g.shape for g in got] == [w.shape for w in want]
        for w, gt in zip(want, got):
            np.testing.assert_allclose(np.asarray(gt), np.asarray(w),
                                       rtol=2e-4, atol=2e-5)

    def test_zero_pad_lanes_are_finite(self):
        """The padded lanes' QP is (σ+ρ)I with zero data: finite, so no NaN
        can leak into a real lane's block."""
        from neo_mpc_planner2_tpu.sqp import _qp_admm_triton

        m, n, block = 9, 3, 32
        zeros = [jnp.zeros((block, r), jnp.float32)
                 for r in (m * m, m, m, n, 2 * n, m, m, m, m, n, m, n)]
        out = _qp_admm_triton(*zeros, iters=4, rho=1.0, sigma=1e-6,
                              block=block, interpret=True)
        for o in out:
            assert np.all(np.asarray(o) == 0.0)


def _solve_inputs(batch):
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch

    cfg = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=8, max_plan_points=16,
        solver_max_iters=3, qp_iters=8,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0)
    sb = make_scenario_batch(cfg, batch, seed=2, map_size=32, plan_points=12)
    scens = mpc.Scenario.create(
        sb.robot_pose, sb.robot_pose * 0.5, sb.robot_pose + 1.0,
        sb.current_vel, sb.footprint, sb.costmap,
        switch_opt=jnp.zeros(batch, bool))
    x0 = jnp.asarray(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 9)),
                     jnp.float32)
    return cfg, x0, scens


def test_qp_kernel_dispatch_integration(monkeypatch):
    """Drive the FULL batched SQP solve through the kernel branch of the QP
    dispatch rule (dxy extraction, broadcasting, padding, outputs) in
    interpret mode on CPU, and compare against the plain-XLA path. Covers
    the rule glue that otherwise only executes on a GPU."""
    from neo_mpc_planner2_tpu import sqp as sqp_mod

    cfg, x0, scens = _solve_inputs(8)
    solve = sqp_mod.make_sqp_solver_batched(cfg, mpc.make_objective(cfg))
    want = solve(x0, scens)

    monkeypatch.setattr(sqp_mod, "_by_platform",
                        lambda args, kernel, plain: kernel(*args))
    monkeypatch.setattr(
        sqp_mod, "_qp_admm_triton",
        partial(sqp_mod._qp_admm_triton, interpret=True))
    got = solve(x0, scens)

    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.iters),
                                  np.asarray(want.iters))


def _lowered_text(platform, batched):
    from neo_mpc_planner2_tpu import sqp as sqp_mod

    cfg, x0, scens = _solve_inputs(8)
    objective = mpc.make_objective(cfg)
    if batched:
        solve = sqp_mod.make_sqp_solver_batched(cfg, objective)
    else:  # one robot, no vmap: the QP's primal path
        solve = lambda x, sc: sqp_mod.make_sqp_solver(cfg, objective)(
            x[0], jax.tree.map(lambda a: a[0], sc))
    return jax.jit(solve).trace(x0, scens).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,batched,kernel", [
    ("cuda", True, True), ("cpu", True, False), ("cuda", False, False)])
def test_platform_choice(platform, batched, kernel):
    """The platform being compiled for picks the path: a CUDA lowering of
    the batched solve holds the Triton QP kernel, a CPU lowering does not,
    and neither does an unbatched solve (no vmap, no batched QP)."""
    txt = _lowered_text(platform, batched)
    assert ("__gpu$xla.gpu.triton" in txt) == kernel
    assert ("qp_admm" in txt) == kernel


@pytest.fixture
def gpu_device():
    """The first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: JAX_PLATFORMS=cuda python -m "
                    "pytest tests/ -m gpu)")
    return dev


@pytest.mark.gpu
@pytest.mark.parametrize("m", [9, 15])
def test_compiled_kernel_matches_plain_on_gpu(gpu_device, m):
    rng = np.random.default_rng(m)
    with jax.default_matmul_precision("highest"):
        got, want = _kernel_vs_plain(_qp_inputs(rng, 300, m=m),
                                     interpret=False)
    for w, gt in zip(want, got):
        np.testing.assert_allclose(np.asarray(gt), np.asarray(w),
                                   rtol=2e-4, atol=2e-5)
