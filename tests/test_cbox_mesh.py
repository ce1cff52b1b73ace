"""The in-repo Cornell box (scene/cbox_mesh.py): deterministic, committed,
and loadable through both OBJ parsers."""

import numpy as np
import pytest

from hijiki.scene.cbox_mesh import CBOX_DIR, CBOX_OBJ, cbox_files, torus_mesh, write_cbox_mesh
from hijiki.scene.model import Emissive
from hijiki.scene.obj import load_obj_scene


def test_generator_reproduces_committed_files(tmp_path):
    obj, mtl = cbox_files()
    assert (obj, mtl) == cbox_files()  # no hidden state between calls
    path = write_cbox_mesh(str(tmp_path))
    for name in ("cbox.obj", "cbox.mtl"):
        with open(tmp_path / name, "rb") as a, open(f"{CBOX_DIR}/{name}", "rb") as b:
            assert a.read() == b.read(), f"{name} drifted from the generator"
    assert path.endswith("cbox.obj")


@pytest.mark.parametrize("backend", ["python", "native"])
def test_loads_through_both_parsers(backend):
    scene = load_obj_scene(CBOX_OBJ, backend=backend)
    tris, mats = scene.triangles()
    assert tris.shape == (6348, 3)
    emissive = [i for i, m in enumerate(scene.materials) if isinstance(m, Emissive)]
    assert emissive == [5]
    assert (mats == 5).sum() == 2  # the light quad, fan-split in two
    # every shading normal is unit length and faces into the box
    n = scene.normals
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


def test_torus_clear_of_the_cbox_spheres():
    """--put-cbox-spheres must not intersect the torus: the tube's surface
    stays outside both spheres (scene/model.py put_cbox_spheres)."""
    pos = np.asarray(torus_mesh()[0])
    for centre in [(-0.4214, 0.3321, -0.28), (0.4458, 0.3321, 0.3767)]:
        assert np.linalg.norm(pos - np.asarray(centre), axis=1).min() > 0.3263
    assert pos.min(axis=0)[1] >= 0.0 and (np.abs(pos[:, [0, 2]]) < 1.0).all()


def test_torus_winding_matches_normals():
    pos, nrm, faces = torus_mesh()
    pos, nrm, faces = np.asarray(pos), np.asarray(nrm), np.asarray(faces)
    a, b, c = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    geo = np.cross(b - a, c - a)
    assert (np.einsum("ij,ij->i", geo, nrm[faces[:, 0]]) > 0).all()
