"""Constant-velocity motion model as a pure pytree transition.

Equivalent of the reference's ``lvt_motion_model``
(lvt/src/lvt_motion_model.cpp:26-65): linear velocity smoothed 50/50 with the
previous velocity; angular velocity as the quaternion difference slerp'd 0.5
toward the previous angular velocity; both integrated one step ahead.
State lives in the VOState pytree instead of a mutable object.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lvt_tpu.geometry import quaternion as quat
from lvt_tpu.geometry.se3 import Pose


class MotionState(NamedTuple):
    last_q: jnp.ndarray        # [4]
    last_position: jnp.ndarray  # [3]
    linear_velocity: jnp.ndarray   # [3]
    angular_velocity: jnp.ndarray  # [4] quaternion per-frame increment

    @staticmethod
    def initial(dtype=jnp.float32) -> "MotionState":
        return MotionState(
            last_q=quat.identity(dtype),
            last_position=jnp.zeros(3, dtype),
            linear_velocity=jnp.zeros(3, dtype),
            angular_velocity=quat.identity(dtype),
        )


def predict_next_pose(state: MotionState, current: Pose) -> tuple[MotionState, Pose]:
    """Update velocities from `current` and integrate one step ahead."""
    new_lin = (current.t - state.last_position + state.linear_velocity) * 0.5

    ang_diff = quat.multiply(current.q, quat.inverse(state.last_q))
    new_ang = quat.normalize(quat.slerp(ang_diff, 0.5, state.angular_velocity))

    predicted = Pose(
        t=current.t + new_lin,
        q=quat.normalize(quat.multiply(current.q, new_ang)),
    )
    next_state = MotionState(
        last_q=current.q,
        last_position=current.t,
        linear_velocity=new_lin,
        angular_velocity=new_ang,
    )
    return next_state, predicted
