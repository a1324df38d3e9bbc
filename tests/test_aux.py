"""Aux subsystem tests: checkpoint/resume, visualization parity helpers,
profiling utilities (SURVEY.md §5 rows)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.checkpoint import load_state, save_state
from neo_mpc_planner2_tpu.utils.profiling import RateTracker, Timer
from neo_mpc_planner2_tpu.utils.se2_np import integrate_cmd_np, yaw_from_quat_np
from neo_mpc_planner2_tpu.utils.viz import carrot_msg, local_plan_msg, plan_msg


class TestCheckpoint:
    def test_npz_roundtrip(self, cfg, tmp_path):
        st = mpc.init_state(cfg)
        st = st.replace(initial_guess=jnp.arange(9, dtype=jnp.float32),
                        waiting_time=jnp.float32(1.5),
                        collision=jnp.asarray(True))
        p = str(tmp_path / "state.npz")
        save_state(p, st)
        back = load_state(p)
        for f in ["initial_guess", "last_control", "waiting_time", "collision",
                  "old_goal", "has_old_goal", "slow_down", "plan_start"]:
            np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                          np.asarray(getattr(st, f)), err_msg=f)

    def test_batched_roundtrip(self, cfg, tmp_path):
        st = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape),
                          mpc.init_state(cfg))
        p = str(tmp_path / "batch.npz")
        save_state(p, st)
        back = load_state(p)
        assert back.initial_guess.shape == (4, 3 * cfg.control_steps)

    def test_resume_continues_identically(self, cfg, empty_costmap, footprint,
                                          tmp_path):
        """Stop/restore mid-mission: the restored engine issues the same next
        command as the uninterrupted one."""
        eng = mpc.MpcEngine(cfg)
        plan = mpc.Plan.create(
            np.stack([np.linspace(0, 2, 30), np.zeros(30), np.zeros(30)], 1),
            max_points=cfg.max_plan_points)
        state = eng.init_state()
        args = (plan, jnp.zeros(3, jnp.float32),
                jnp.asarray([0.3, 0.0, 0.0], jnp.float32), empty_costmap,
                footprint, 0.033)
        out1 = eng.step(state, *args)
        p = str(tmp_path / "mid.npz")
        save_state(p, out1.state)
        out_direct = eng.step(out1.state, *args)
        out_resumed = eng.step(load_state(p), *args)
        np.testing.assert_allclose(np.asarray(out_direct.cmd_vel),
                                   np.asarray(out_resumed.cmd_vel), atol=1e-7)


class TestViz:
    def test_local_plan_msg(self):
        lp = np.array([[0.1, 0.0, 0.0], [0.2, 0.05, 0.3]])
        msg = local_plan_msg(lp)
        assert len(msg["poses"]) == 2
        q = msg["poses"][1]["pose"]["orientation"]
        assert yaw_from_quat_np(q["x"], q["y"], q["z"], q["w"]) == pytest.approx(0.3)

    def test_carrot_msg_z(self):
        m = carrot_msg(np.array([0.4, 0.1, 0.2]))
        assert m["point"]["z"] == 0.01  # cpp:198 'right over map to stand out'

    def test_plan_msg_valid_count(self):
        poses = np.zeros((10, 3))
        assert len(plan_msg(poses, 6)["poses"]) == 6


class TestProfiling:
    def test_timer_phases(self):
        t = Timer()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        s = t.summary()
        assert s["a"]["count"] == 2

    def test_rate_tracker(self):
        r = RateTracker()
        for _ in range(10):
            r.record(0.01)
        st = r.stats()
        assert st["p50_ms"] == pytest.approx(10.0)
        assert st["rate_hz"] == pytest.approx(100.0)


def test_integrate_cmd_np_matches_rollout():
    pose = np.array([0.3, -0.2, 0.4])
    cmd = np.array([0.5, -0.1, 0.3])
    got = integrate_cmd_np(pose, cmd, 0.1)
    want = np.asarray(mpc.rollout(jnp.asarray(cmd)[None, :], jnp.float32(0.1),
                                  jnp.asarray(pose, jnp.float32)))[0]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_predicted_footprint_msg():
    from neo_mpc_planner2_tpu.utils.viz import predicted_footprint_msg

    m = predicted_footprint_msg(np.array([[0.3, 0.2], [-0.3, 0.2]]),
                                np.array([1.0, 2.0, np.pi / 2]))
    p0 = m["polygon"]["points"][0]
    assert p0["x"] == pytest.approx(1.0 - 0.2)
    assert p0["y"] == pytest.approx(2.0 + 0.3)


def test_device_trace_writes(tmp_path):
    import jax
    import jax.numpy as jnp
    from neo_mpc_planner2_tpu.utils.profiling import device_trace

    with device_trace(str(tmp_path / "trace")):
        jax.jit(lambda x: x * 2)(jnp.ones(8)).block_until_ready()
    import os
    assert any(os.scandir(tmp_path / "trace"))


def test_compile_cache_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR populates a persistent XLA compilation
    cache through the entry-point helper, which sets nothing itself when the
    variable is set (subprocess: JAX reads the variable at import)."""
    import os
    import subprocess
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=repo_root,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    code = (
        "import jax\n"
        "from neo_mpc_planner2_tpu.utils.compile_cache import enable_compile_cache\n"
        f"assert enable_compile_cache() == {str(tmp_path)!r}\n"
        f"assert jax.config.jax_compilation_cache_dir == {str(tmp_path)!r}\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)\n"
        "import jax.numpy as jnp\n"
        "jax.jit(lambda x: (x*3).sum())(jnp.ones((256, 256))).block_until_ready()\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=240)
    assert any(tmp_path.iterdir()), "cache dir stayed empty"
