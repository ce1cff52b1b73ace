"""Native C++ OBJ parser vs the pure-Python reference parser: identical
Scenes (arrays bitwise, materials, compiled output) on real and synthetic
files, including smoothing-group normal generation and negative indices."""

import numpy as np
import pytest

from hijiki.scene.cbox_mesh import CBOX_OBJ
from hijiki.scene.compile import compile_scene
from hijiki.scene.obj import load_obj_scene
from hijiki.scene.obj_native import load_library


pytestmark = pytest.mark.skipif(
    load_library() is None, reason="native OBJ parser unavailable"
)


def _assert_scene_equal(a, b):
    """a = python (Triangle objects), b = native (bulk arrays)."""
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.normals, b.normals)
    np.testing.assert_array_equal(a.uvs, b.uvs)
    tri_a = np.array([t.indices for t, _ in a.objects], np.int32).reshape(-1, 3)
    mat_a = np.array([m for _, m in a.objects], np.int32)
    np.testing.assert_array_equal(tri_a, b.bulk_tris)
    np.testing.assert_array_equal(mat_a, b.bulk_tri_mats)
    assert [repr(m) for m in a.materials] == [repr(m) for m in b.materials]


def _both(path):
    return (
        load_obj_scene(str(path), backend="python"),
        load_obj_scene(str(path), backend="native"),
    )


def test_cbox_parity():
    a, b = _both(CBOX_OBJ)
    _assert_scene_equal(a, b)
    ca, cb = compile_scene(a), compile_scene(b)
    np.testing.assert_array_equal(ca.trace_rows, cb.trace_rows)
    np.testing.assert_array_equal(ca.materials, cb.materials)
    np.testing.assert_array_equal(ca.emitter_cdf, cb.emitter_cdf)


def test_smoothing_and_flat_normals(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl white\nKd 0.8 0.8 0.8\nnewmtl lighty\nKe 5 5 5\n"
    )
    obj = """mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 0 1
v 0 1 1
v 0 2 0
usemtl white
s 1
f 1 2 3
f 1 3 4
s off
f 1 2 5
f -5 -3 -1
"""
    p = tmp_path / "s.obj"
    p.write_text(obj)
    a, b = _both(p)
    _assert_scene_equal(a, b)


def test_mixed_normals_uv_and_skipped_faces(tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl red\nKd 1 0 0\n")
    obj = """mtllib m.mtl
v 0 0 0
v 1 0 0
v 0 1 0
vt 0.5 0.5
vn 0 0 1
f 1 2 3
usemtl red
f 1/1/1 2/1 3//1
g other
f 1/1/1 2/1 3//1
usemtl unknown_material
f 1 2 3
"""
    p = tmp_path / "mix.obj"
    p.write_text(obj)
    a, b = _both(p)
    # the pre-usemtl face and the unknown-material face are skipped
    assert len(a.objects) == 2
    _assert_scene_equal(a, b)


def test_duplicate_newmtl_and_repeated_mtllib(tmp_path):
    """obj.py keeps only the FIRST occurrence of a material name (later
    duplicates are dropped entirely, their Kd/Ke ignored); the native parser
    must match — including a duplicate light* entry that lacks Ke, which must
    not raise, and duplicates arriving via a twice-referenced mtllib."""
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 1 0 0\n"
        "newmtl lightA\nKe 5 5 5\n"
        "newmtl red\nKd 0 1 0\n"  # duplicate: dropped, Kd must stay 1 0 0
        "newmtl lightA\nKd 0.5 0.5 0.5\n"  # duplicate light WITHOUT Ke: dropped
        "newmtl blue\nKd 0 0 1\n"
    )
    obj = """mtllib m.mtl
mtllib m.mtl
v 0 0 0
v 1 0 0
v 0 1 0
usemtl red
f 1 2 3
usemtl blue
f 1 2 3
usemtl lightA
f 1 2 3
"""
    p = tmp_path / "dup.obj"
    p.write_text(obj)
    a, b = _both(p)
    # first occurrences only, in declaration order: red(1,0,0), lightA, blue
    assert len(a.materials) == 3
    assert a.materials[0].color == (1.0, 0.0, 0.0)
    _assert_scene_equal(a, b)
    np.testing.assert_array_equal(
        compile_scene(a).materials, compile_scene(b).materials
    )


def test_quads_fan_triangulation(tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl w\nKd 1 1 1\n")
    obj = """mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0 0
vn 0 0 1
usemtl w
f 1//1 2//1 3//1 4//1 5//1
"""
    p = tmp_path / "q.obj"
    p.write_text(obj)
    a, b = _both(p)
    assert b.bulk_tris.shape[0] == 3  # 5-gon -> 3 fan triangles
    _assert_scene_equal(a, b)


def test_out_of_range_index_fails_loudly(tmp_path):
    """A doubly-negative (or past-the-end) face index must be a hard error
    in BOTH backends — Python list wrap-around would silently alias the
    wrong vertex (obj.py raises; the native parser fails the parse, so its
    wrapper returns None and load falls back to the raising path)."""
    import pytest

    from hijiki.scene.obj import load_obj_scene
    from hijiki.scene.obj_native import parse_obj_native

    (tmp_path / "m.mtl").write_text("newmtl white\nKd 0.8 0.8 0.8\n")
    for bad_face in ("f -5 -3 -2", "f 1 2 9"):
        p = tmp_path / "bad.obj"
        p.write_text(
            "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 1 1\n"
            f"usemtl white\n{bad_face}\n"
        )
        assert parse_obj_native(str(p)) is None
        with pytest.raises((ValueError, IndexError)):
            load_obj_scene(str(p), backend="python")
        # backend="native" with a WORKING parser must report a parse
        # failure, not "parser unavailable"
        from hijiki.scene.obj_native import load_library

        if load_library() is not None:
            with pytest.raises(ValueError, match="parse failed"):
                load_obj_scene(str(p), backend="native")
