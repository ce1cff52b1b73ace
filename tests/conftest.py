"""Test harness config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is tested without accelerators via
``--xla_force_host_platform_device_count=8`` (the reference offers no
multi-device precedent, so this is net-new; see SURVEY.md §4). Must run
before jax initializes its backends.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# jax.config wins over the env var once jax is imported; pin both.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def cbox_scene():
    from hijiki.scene.obj import load_obj_scene

    from hijiki.scene.cbox_mesh import CBOX_OBJ

    return load_obj_scene(CBOX_OBJ)


@pytest.fixture(scope="session")
def cbox_compiled(cbox_scene):
    import copy

    from hijiki.scene.compile import compile_scene, scene_to_device

    scene = copy.deepcopy(cbox_scene)
    scene.put_cbox_spheres()
    return scene_to_device(compile_scene(scene))


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(42)


@pytest.fixture()
def gpu():
    """The card's device summary; skips the test off the card. Tests that
    need the GPU take this fixture (and carry the ``gpu`` marker) instead of
    deciding at import, so every pytest-xdist worker collects the same tests.
    chip_smoke.py covers what they check on the card."""
    from hijiki.utils.platform import device_summary

    summary = device_summary()
    if summary["platform"] != "gpu":
        pytest.skip(f"needs a GPU; jax runs on {summary['platform']}")
    return summary
