"""Camera ray generation (quaternion pinhole camera).

Reference: ``getCameraRayAt`` (``shader/render.glsl:26-36``): horizontal-FOV
pinhole model; the unnormalized direction (x, -y, -1) is rotated by the camera
quaternion and then normalized. tMin = M_EPS, tMax = +inf (the reference's
GLSL literal 1e100 overflows to f32 +inf).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from hijiki.utils.quaternion import quaternion_rotate

# numpy scalar, NOT jnp: a module-level jnp constant becomes a captured
# device array inside jit instead of a compile-time literal
M_EPS = np.float32(1e-4)


def camera_rays(cam_position, cam_rotation, cam_fov_deg, pixel_xy, dimension):
    """Generate camera rays.

    Args:
      cam_position: (3,) f32.
      cam_rotation: (4,) f32 quaternion (x,y,z,w).
      cam_fov_deg: scalar f32, horizontal fov in degrees.
      pixel_xy: (..., 2) f32 — sample position in image coords (pixel + jitter).
      dimension: (2,) f32 — image (width, height).

    Returns:
      (origins (...,3), directions (...,3), tmin (...,), tmax (...,))
    """
    dim = jnp.asarray(dimension, jnp.float32)
    x = pixel_xy - jnp.float32(0.5) * dim
    half_fov = jnp.float32(0.5) * jnp.radians(cam_fov_deg.astype(jnp.float32))
    x = x * jnp.tan(half_fov) / (jnp.float32(0.5) * dim[0])
    d_local = jnp.stack(
        [x[..., 0], -x[..., 1], -jnp.ones_like(x[..., 0])], axis=-1
    )
    d = quaternion_rotate(d_local, jnp.broadcast_to(cam_rotation, d_local.shape[:-1] + (4,)), jnp)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam_position, d.shape)
    shape = d.shape[:-1]
    return (
        o,
        d,
        jnp.full(shape, M_EPS, jnp.float32),
        jnp.full(shape, jnp.inf, jnp.float32),
    )
