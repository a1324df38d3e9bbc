"""SE(2) geometry primitives as pure JAX ops.

Replaces the reference's tf2 transform stack (NeoMpcPlanner.h:140, cpp:137-155)
and its quaternion helpers (mpc_optimization_server.py:160-196). There is no TF
tree: callers pass explicit frames. Poses are (..., 3) arrays [x, y, yaw];
quaternions are (..., 4) arrays [x, y, z, w] (ROS field order).

All functions broadcast over leading batch dimensions and are jit/vmap/grad-safe.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "yaw_from_quat",
    "quat_from_yaw",
    "rot2",
    "se2_apply",
    "se2_inverse",
    "se2_compose",
    "world_to_body",
    "body_to_world",
    "wrap_angle",
]


def yaw_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Yaw from quaternion [..., (x, y, z, w)].

    Matches euler_from_quaternion (mpc_optimization_server.py:176-178):
    yaw = atan2(2(wz + xy), 1 - 2(y² + z²)).
    """
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    t3 = 2.0 * (w * z + x * y)
    t4 = 1.0 - 2.0 * (y * y + z * z)
    return jnp.arctan2(t3, t4)


def quat_from_yaw(yaw: jnp.ndarray) -> jnp.ndarray:
    """Quaternion [..., (x, y, z, w)] for a pure-yaw rotation.

    Matches quaternion_from_euler with roll=pitch=0
    (mpc_optimization_server.py:182-196, which returns [w, x, y, z]; we return
    ROS field order [x, y, z, w]).
    """
    half = yaw * 0.5
    zeros = jnp.zeros_like(yaw)
    return jnp.stack([zeros, zeros, jnp.sin(half), jnp.cos(half)], axis=-1)


def rot2(theta: jnp.ndarray) -> jnp.ndarray:
    """(..., 2, 2) rotation matrix."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def se2_apply(pose: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply pose [x, y, yaw] to points (..., 2): R(yaw) @ p + t."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    px, py = points[..., 0], points[..., 1]
    out_x = pose[..., 0] + px * c - py * s
    out_y = pose[..., 1] + px * s + py * c
    return jnp.stack([out_x, out_y], axis=-1)


def se2_inverse(pose: jnp.ndarray) -> jnp.ndarray:
    """Inverse of an SE(2) pose [x, y, yaw]."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    inv_x = -(x * c + y * s)
    inv_y = -(-x * s + y * c)
    return jnp.stack([inv_x, inv_y, -pose[..., 2]], axis=-1)


def se2_compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a ∘ b: apply b in a's frame. Result [x, y, yaw]."""
    xy = se2_apply(a, b[..., :2])
    return jnp.concatenate([xy, (a[..., 2:3] + b[..., 2:3])], axis=-1)


def world_to_body(robot_pose: jnp.ndarray, world_pose: jnp.ndarray) -> jnp.ndarray:
    """Express world_pose [.., 3] in the robot's base frame.

    Device stand-in for the tf2 transform of the global plan into
    costmap_ros_->getBaseFrameID() (NeoMpcPlanner.cpp:109-124).
    """
    return se2_compose(se2_inverse(robot_pose), world_pose)


def body_to_world(robot_pose: jnp.ndarray, body_pose: jnp.ndarray) -> jnp.ndarray:
    return se2_compose(robot_pose, body_pose)


def wrap_angle(theta: jnp.ndarray) -> jnp.ndarray:
    """Wrap to [-pi, pi). The reference never wraps (SURVEY.md §2.3); used only
    by product-mode costs."""
    return jnp.mod(theta + jnp.pi, 2.0 * jnp.pi) - jnp.pi
