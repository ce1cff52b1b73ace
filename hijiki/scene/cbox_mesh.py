"""The repository's Cornell box as a triangle mesh (OBJ + MTL).

The reference renders ``scenes/cbox`` (a triangle-mesh Cornell box with a
teapot). That asset is not redistributed, so this module builds a stand-in
from code: the box layout of ``scene/presets.py`` (x, z in [-1, 1], y in
[0, 2], open towards the +z camera, 0.5 x 0.5 light just under the ceiling)
as two-triangle wall quads, plus a closed smooth torus of about the teapot's
triangle count standing against the back wall. Materials follow the
reference's MTL conventions (``src/main.rs:432-458``): ``Kd`` diffuse walls
(white, red left, green right) and an emissive ``light`` quad whose power is
the ``Ke`` key. Every shading normal faces into the box, as the reference's
one-sided NEE gate and emitter cosine expect.

The output is deterministic (fixed tessellation, fixed decimal formatting)
and committed under ``scenes/cbox_mesh/``; ``tests/test_cbox_mesh.py`` checks
that this generator still writes exactly the committed bytes.

Regenerate with ``python -m hijiki.scene.cbox_mesh [out_dir]``.
"""

from __future__ import annotations

import math
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CBOX_DIR = os.path.join(REPO_ROOT, "scenes", "cbox_mesh")
CBOX_OBJ = os.path.join(CBOX_DIR, "cbox.obj")

WHITE = (0.725, 0.71, 0.68)
# (name, Kd, Ke); names starting with "light" are emissive (src/main.rs:432)
MATERIALS = (
    ("floor", WHITE, None),
    ("ceiling", WHITE, None),
    ("backWall", WHITE, None),
    ("leftWall", (0.63, 0.065, 0.05), None),
    ("rightWall", (0.14, 0.45, 0.091), None),
    ("light", (0.0, 0.0, 0.0), (15.0, 15.0, 15.0)),
    ("torus", WHITE, None),
)

# (material, origin, edge1, edge2, inward normal); edge1 x edge2 is along the
# normal, so the fan (p0, p0+e1, p0+e1+e2, p0+e2) winds the same way
QUADS = (
    ("floor", (-1, 0, 1), (2, 0, 0), (0, 0, -2), (0, 1, 0)),
    ("ceiling", (-1, 2, -1), (2, 0, 0), (0, 0, 2), (0, -1, 0)),
    ("backWall", (-1, 0, -1), (2, 0, 0), (0, 2, 0), (0, 0, 1)),
    ("leftWall", (-1, 0, 1), (0, 0, -2), (0, 2, 0), (1, 0, 0)),
    ("rightWall", (1, 0, -1), (0, 0, 2), (0, 2, 0), (-1, 0, 0)),
    ("light", (-0.25, 1.98, -0.25), (0.5, 0, 0), (0, 0, 0.5), (0, -1, 0)),
)

# Torus standing on the floor, its ring in the xy-plane facing the camera.
# Placed behind the --put-cbox-spheres spheres (scene/model.py) so that
# neither sphere intersects it. 96 x 33 quads = 6,336 triangles, close to
# the reference teapot's count.
TORUS_CENTER = (0.0, 0.4, -0.72)
TORUS_MAJOR = 0.3
TORUS_MINOR = 0.1
TORUS_RING_SEGMENTS = 96
TORUS_TUBE_SEGMENTS = 33


def _fmt(x: float) -> str:
    s = f"{x:.6f}"
    return "0.000000" if s == "-0.000000" else s


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _dot(a, b):
    return sum(x * y for x, y in zip(a, b))


def torus_mesh():
    """(positions, normals, faces): faces are 0-based index triples into
    both pools (one normal per position), wound so that the geometric normal
    agrees with the outward shading normal."""
    cx, cy, cz = TORUS_CENTER
    nu, nv = TORUS_RING_SEGMENTS, TORUS_TUBE_SEGMENTS
    pos, nrm = [], []
    for i in range(nu):
        u = 2.0 * math.pi * i / nu
        for j in range(nv):
            v = 2.0 * math.pi * j / nv
            n = (math.cos(v) * math.cos(u), math.cos(v) * math.sin(u), math.sin(v))
            ring = TORUS_MAJOR + TORUS_MINOR * math.cos(v)
            pos.append((cx + ring * math.cos(u), cy + ring * math.sin(u),
                        cz + TORUS_MINOR * math.sin(v)))
            nrm.append(n)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces += [(a, b, c), (a, c, d)]
    # orient every face by the first one: the parametrization is regular, so
    # one check decides the winding for all
    pa, pb, pc = (pos[k] for k in faces[0])
    geo = _cross(tuple(y - x for x, y in zip(pa, pb)), tuple(y - x for x, y in zip(pa, pc)))
    if _dot(geo, nrm[faces[0][0]]) < 0:
        faces = [(a, c, b) for a, b, c in faces]
    return pos, nrm, faces


def cbox_files() -> tuple[str, str]:
    """(obj_text, mtl_text) of the in-repo Cornell box."""
    mtl = ["# Cornell box materials (hijiki.scene.cbox_mesh)"]
    for name, kd, ke in MATERIALS:
        mtl.append(f"newmtl {name}")
        mtl.append("Kd " + " ".join(_fmt(x) for x in kd))
        if ke is not None:
            mtl.append("Ke " + " ".join(_fmt(x) for x in ke))
    obj = [
        "# Cornell box with a procedural torus (hijiki.scene.cbox_mesh)",
        "mtllib cbox.mtl",
    ]
    nv = 0
    for name, p0, e1, e2, n in QUADS:
        assert _dot(_cross(e1, e2), n) > 0, name
        corners = (
            p0,
            tuple(a + b for a, b in zip(p0, e1)),
            tuple(a + b + c for a, b, c in zip(p0, e1, e2)),
            tuple(a + c for a, c in zip(p0, e2)),
        )
        obj.append(f"o {name}")
        obj += ["v " + " ".join(_fmt(x) for x in c) for c in corners]
        obj += ["vn " + " ".join(_fmt(x) for x in n)] * 4
        obj.append(f"usemtl {name}")
        obj.append("f " + " ".join(f"{nv + k}//{nv + k}" for k in range(1, 5)))
        nv += 4
    pos, nrm, faces = torus_mesh()
    obj.append("o torus")
    obj += ["v " + " ".join(_fmt(x) for x in p) for p in pos]
    obj += ["vn " + " ".join(_fmt(x) for x in n) for n in nrm]
    obj.append("usemtl torus")
    obj.append("s 1")
    obj += [
        "f " + " ".join(f"{nv + k + 1}//{nv + k + 1}" for k in face) for face in faces
    ]
    return "\n".join(obj) + "\n", "\n".join(mtl) + "\n"


def write_cbox_mesh(out_dir: str = CBOX_DIR) -> str:
    """Write cbox.obj + cbox.mtl into ``out_dir``; returns the OBJ path."""
    os.makedirs(out_dir, exist_ok=True)
    obj, mtl = cbox_files()
    with open(os.path.join(out_dir, "cbox.mtl"), "w") as f:
        f.write(mtl)
    path = os.path.join(out_dir, "cbox.obj")
    with open(path, "w") as f:
        f.write(obj)
    return path


if __name__ == "__main__":
    print(write_cbox_mesh(*sys.argv[1:2]))
