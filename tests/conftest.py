"""Test harness: run everything on a virtual 8-device CPU mesh.

This mirrors how multi-chip code is validated without a pod slice: the same
Mesh/NamedSharding code paths execute on fake CPU devices
(xla_force_host_platform_device_count), per the build plan in SURVEY.md
sections 4 and 7 (M5). jax.config.update as well as the environment, in
case jax was imported before this file runs.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(42)
