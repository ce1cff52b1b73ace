"""Scene loading + compilation: cbox conventions, material packing, emitters."""

import numpy as np

from hijiki.scene.compile import compile_scene
from hijiki.scene.model import (
    Diffuse,
    Emissive,
    MATERIAL_TAG_SHIFT,
    TAG_DIFFUSE,
    TAG_DIFFUSECBOARD,
    TAG_EMISSIVE,
    TAG_MIRROR,
)


import pytest

# fast per-commit gate tier (README: python -m pytest tests -m quick)
pytestmark = pytest.mark.quick


def test_cbox_materials(cbox_scene):
    # MTL order: floor, ceiling, backWall, leftWall, rightWall, light, torus
    mats = cbox_scene.materials
    assert len(mats) == 7
    assert isinstance(mats[5], Emissive)
    assert mats[5].power == (15.0, 15.0, 15.0)
    assert all(isinstance(m, Diffuse) for i, m in enumerate(mats) if i != 5)
    np.testing.assert_allclose(mats[0].color, (0.725, 0.71, 0.68))
    # leftWall (red) and rightWall (green) Kd
    np.testing.assert_allclose(mats[3].color, (0.63, 0.065, 0.05))
    np.testing.assert_allclose(mats[4].color, (0.14, 0.45, 0.091))


def test_cbox_geometry(cbox_scene):
    # 6 quad faces fan-triangulated + a 96 x 33 torus = 12 + 6336 triangles
    tris, tri_mats = cbox_scene.triangles()
    assert tris.shape == (6348, 3)
    assert cbox_scene.positions.shape == (4 * 6 + 96 * 33, 3)
    assert cbox_scene.normals.shape == (4 * 6 + 96 * 33, 3)
    cam = cbox_scene.camera
    np.testing.assert_allclose(cam.position, [0.0, 0.91, 5.41])
    assert abs(cam.fov - 27.7) < 1e-6
    half = 0.5 * np.radians(-1.45)
    np.testing.assert_allclose(cam.rotation, [np.sin(half), 0, 0, np.cos(half)], rtol=1e-6)


def test_compiled_handles_and_emitters(cbox_scene):
    import copy

    scene = copy.deepcopy(cbox_scene)
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    assert (cs.num_spheres, cs.num_quads, cs.num_triangles) == (2, 0, 6348)
    # sphere materials come first in global shape order
    tags = np.asarray(cs.materials) >> MATERIAL_TAG_SHIFT
    assert tags[0] == TAG_MIRROR
    assert tags[1] == TAG_DIFFUSECBOARD
    # two emissive triangles (the light quad split in two), uniform pdf + cdf
    assert cs.num_emitters == 2
    np.testing.assert_allclose(cs.emitter_pdf[:2], [0.5, 0.5])
    np.testing.assert_allclose(cs.emitter_cdf[:2], [0.5, 1.0])
    em = np.asarray(cs.emitter_shape[:2])
    assert np.all(tags[em] == TAG_EMISSIVE)
    # emissive power table
    np.testing.assert_allclose(np.asarray(cs.emissive_power[0]), [15.0, 15.0, 15.0])
    # diffuse handles index into the diffuse table
    dif = np.nonzero(tags == TAG_DIFFUSE)[0]
    idxs = np.asarray(cs.materials)[dif] & ((1 << MATERIAL_TAG_SHIFT) - 1)
    assert idxs.max() < cs.diffuse_color.shape[0]


def test_bvh_structure(cbox_scene):
    import copy

    scene = copy.deepcopy(cbox_scene)
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    n = cs.num_bvh_nodes
    count = np.asarray(cs.bvh_count)
    first = np.asarray(cs.bvh_first)
    exit_ = np.asarray(cs.bvh_exit)
    # leaf_size=1: every prim in exactly one leaf
    assert count.sum() == cs.num_prims
    order = np.asarray(cs.prim_shape_id)
    assert sorted(order.tolist()) == list(range(cs.num_prims))
    # threaded invariants: exits strictly increase past the node, root exit = n
    assert exit_[0] == n
    assert np.all(exit_ > np.arange(n))
    assert np.all(exit_ <= n)
    # interior first = self+1 (preorder left child)
    interior = count == 0
    assert np.all(first[interior] == np.nonzero(interior)[0] + 1)
    # children AABBs contained in parent (left child = i+1)
    amin = np.asarray(cs.bvh_aabb_min)
    amax = np.asarray(cs.bvh_aabb_max)
    par = np.nonzero(interior)[0]
    assert np.all(amin[par] <= amin[par + 1] + 1e-6)
    assert np.all(amax[par] >= amax[par + 1] - 1e-6)


def test_builtin_cornell_presets():
    """Built-in procedural scenes compile and light up (standalone, no OBJ)."""
    import jax.numpy as jnp
    import numpy as np

    from hijiki.ops.camera import camera_rays
    from hijiki.ops.integrate import integrate
    from hijiki.ops.rng import seed_rng
    from hijiki.scene.compile import compile_scene, scene_to_device
    from hijiki.scene.presets import PRESETS, load_preset

    for name in PRESETS:
        cs = compile_scene(load_preset(name))
        assert cs.num_emitters == 1
    cs = scene_to_device(compile_scene(load_preset("cornell-spheres")))
    W = H = 24
    y, x = np.mgrid[0:H, 0:W]
    pxy = jnp.asarray(
        np.stack([x + 0.5, y + 0.5], -1).reshape(-1, 2).astype(np.float32)
    )
    o, d, tmin, tmax = camera_rays(
        cs.cam_position, cs.cam_rotation, cs.cam_fov, pxy,
        jnp.asarray([W, H], jnp.float32),
    )
    seeds = jnp.asarray((np.arange(W * H) * 2654435761 % (1 << 32)).astype(np.uint32))
    out = integrate(cs, o, d, tmin, tmax, seed_rng(seeds), max_bounces=8,
                    traversal="rows")
    img = np.asarray(out.total)
    assert np.isfinite(img).all()
    assert img.mean() > 0.02  # lit


def test_bvh_transforms_preserve_invariants():
    """collapse_bvh / order_children_by_area keep the threaded-preorder
    contract: exit[i] == i + subtree_size(i), every node visited exactly once
    by the always-descend walk, leaves keep all prims, boxes contain their
    subtrees' prims."""
    import numpy as np

    from hijiki.accel.bvh import build_bvh, collapse_bvh, order_children_by_area

    rng = np.random.default_rng(0)
    n = 500
    mn = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    b0 = build_bvh(mn, mx, leaf_size=1)

    def check(b):
        N = b.num_nodes
        visited = np.zeros(N, bool)
        cur = 0
        steps = 0
        while cur < N and steps <= N:
            assert not visited[cur]
            visited[cur] = True
            steps += 1
            cur = int(b.exit[cur]) if b.count[cur] > 0 else cur + 1
        assert visited.all() and steps == N
        prims = []
        for i in range(N):
            if b.count[i] > 0:
                prims.extend(b.prim_order[b.first[i]:b.first[i] + b.count[i]].tolist())
        assert sorted(prims) == list(range(n))
        # each interior box contains its children's boxes
        for i in range(N):
            if b.count[i] == 0:
                c = i + 1
                while c < b.exit[i]:
                    assert (b.aabb_min[i] <= b.aabb_min[c] + 1e-5).all()
                    assert (b.aabb_max[i] >= b.aabb_max[c] - 1e-5).all()
                    c = int(b.exit[c])

    check(b0)
    for rounds in (1, 2):
        check(collapse_bvh(b0, rounds))
    check(order_children_by_area(b0))
    check(order_children_by_area(collapse_bvh(b0, 1)))


def test_obj_generated_normals(tmp_path):
    """OBJs without vn get generated normals: smooth (area-weighted) within a
    smoothing group, flat with smoothing off; files with vn are untouched."""
    from hijiki.scene.obj import load_obj_scene

    (tmp_path / "m.mtl").write_text("newmtl white\nKd 0.8 0.8 0.8\n")
    # two triangles sharing edge (0,0,0)-(1,0,1): one in xz-plane (normal +y),
    # one slanted; smooth group => shared vertices get a blended normal
    obj = """mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 0 1
v 0 1 1
usemtl white
s 1
f 1 2 3
f 1 3 4
"""
    p = tmp_path / "smooth.obj"
    p.write_text(obj)
    scene = load_obj_scene(str(p))
    tris, _ = scene.triangles()
    assert tris.shape[0] == 2
    n = scene.normals
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
    # shared vertices (v1, v3) blend both faces: not equal to either face normal
    tri0 = tuple(tris[0])
    tri1 = tuple(tris[1])
    shared = set(tri0) & set(tri1)
    assert len(shared) == 2
    f0 = np.cross(
        scene.positions[tri0[1]] - scene.positions[tri0[0]],
        scene.positions[tri0[2]] - scene.positions[tri0[0]],
    )
    f0 /= np.linalg.norm(f0)
    sv = next(iter(shared))
    assert not np.allclose(n[sv], f0, atol=1e-4)

    # flat: same geometry, no smoothing -> six distinct vertices, each face's
    # vertices carry exactly the face normal
    p2 = tmp_path / "flat.obj"
    p2.write_text(obj.replace("s 1\n", ""))
    sc2 = load_obj_scene(str(p2))
    tris2, _ = sc2.triangles()
    t0 = tuple(tris2[0])
    assert len(set(t0) & set(tuple(tris2[1]))) == 0
    for iv in t0:
        assert np.allclose(sc2.normals[iv], f0, atol=1e-6)
