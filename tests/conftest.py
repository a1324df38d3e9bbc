"""Test configuration: CPU with an 8-device virtual mesh by default.

Multi-device sharding is exercised without several GPUs via JAX's standard
trick (SURVEY.md §4): XLA_FLAGS=--xla_force_host_platform_device_count=8 on
the CPU backend. Must run before jax is imported anywhere. A run that sets
JAX_PLATFORMS itself keeps it: `JAX_PLATFORMS=cuda python -m pytest tests/
-m gpu` runs the GPU-marked tests on a card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

import neo_mpc_planner2_tpu as mpc


@pytest.fixture(scope="session")
def cfg():
    """Sample-config-flavored test config (README.md:51-84 values, smaller
    footprint sampling for oracle speed — both sides use the same count)."""
    return mpc.default_config().replace(
        prediction_horizon=0.8,
        control_steps=3,
        opt_tolerance=1e-3,
        footprint_edge_samples=8,
        acc_x_limit=2.5,
        acc_y_limit=2.5,
        acc_theta_limit=3.0,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )


@pytest.fixture(scope="session")
def empty_costmap():
    return mpc.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0), resolution=0.05)


@pytest.fixture(scope="session")
def footprint():
    return mpc.Footprint.rectangle(0.6, 0.4)


@pytest.fixture(scope="session")
def footprint_np():
    return np.array([[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]])
