"""Platform plumbing: the pytree dataclass helper, the compile-cache rule,
optional orbax, and the smoke script's refusal to run without a GPU."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.utils import compile_cache, struct

REPO = pathlib.Path(__file__).resolve().parent.parent


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    tag: str = struct.field(pytree_node=False, default="x")


class TestStruct:
    def test_replace_and_frozen(self):
        p = _Pair(jnp.ones(2), jnp.zeros(2))
        q = p.replace(b=jnp.full(2, 3.0))
        np.testing.assert_array_equal(np.asarray(q.b), [3.0, 3.0])
        np.testing.assert_array_equal(np.asarray(p.b), [0.0, 0.0])
        with pytest.raises(dataclasses.FrozenInstanceError):
            p.a = jnp.ones(3)

    def test_static_field_is_treedef_not_leaf(self):
        p = _Pair(jnp.ones(2), None, tag="y")
        leaves, treedef = jax.tree.flatten(p)
        assert len(leaves) == 1  # None is an empty subtree; tag is static
        assert jax.tree.unflatten(treedef, leaves).tag == "y"
        assert (jax.tree.structure(p)
                != jax.tree.structure(p.replace(tag="z")))

    def test_vmap_jit_roundtrip(self):
        p = _Pair(jnp.arange(6.0).reshape(3, 2), jnp.ones((3, 2)), tag="s")
        out = jax.jit(jax.vmap(
            lambda q: q.replace(a=q.a * 2 + q.b)))(p)
        assert isinstance(out, _Pair) and out.tag == "s"
        np.testing.assert_array_equal(np.asarray(out.a),
                                      np.arange(6.0).reshape(3, 2) * 2 + 1)

    def test_engine_types_use_it(self):
        cm = mpc.Costmap.create(np.zeros((8, 8)), origin=(0.0, 0.0),
                                resolution=0.1)
        view = cm.replace(win_lo=jnp.zeros(2, jnp.int32), win_cells=4)
        assert len(jax.tree.leaves(view)) == len(jax.tree.leaves(cm)) + 1
        st = jax.jit(lambda s: s.replace(
            waiting_time=s.waiting_time + 1))(mpc.init_state(mpc.default_config()))
        assert isinstance(st, mpc.ControlState)
        assert float(st.waiting_time) == 1.0


class TestCompileCache:
    def test_env_set_is_left_to_jax(self, monkeypatch, tmp_path):
        calls = []
        monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path))
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_env_unset_uses_checkout_dir(self, monkeypatch):
        calls = []
        monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path = compile_cache.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        # The same fixed path every time: the path is part of the key.
        assert compile_cache.enable_compile_cache() == path

    def test_import_sets_nothing(self):
        code = ("import jax, neo_mpc_planner2_tpu; "
                "print(jax.config.jax_compilation_cache_dir)")
        env = {k: v for k, v in os.environ.items()
               if k != compile_cache.CACHE_ENV}
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "None"


def test_orbax_absent_names_npz(monkeypatch, tmp_path):
    from neo_mpc_planner2_tpu import checkpoint

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    st = mpc.init_state(mpc.default_config())
    with pytest.raises(ImportError, match=r"\.npz"):
        checkpoint.save_state(str(tmp_path / "dir_ckpt"), st)
    with pytest.raises(ImportError, match=r"\.npz"):
        checkpoint.load_state(str(tmp_path / "dir_ckpt"))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """No GPU: non-zero exit, and no result line."""
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_chip_smoke_alone_fails(tmp_path):
    """The script without the program beside it fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
    with pytest.raises(ValueError):
        json.loads(lines[-1] if lines else "")
