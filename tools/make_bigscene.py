"""Generate a large OBJ by 4-1 loop-splitting the in-repo Cornell box.

Each triangle splits into 4 at its edge midpoints, positions/normals/UVs
interpolated linearly (normals re-normalized by the renderer's smooth
shading), materials and usemtl structure preserved — so the subdivided scene
renders the SAME image as cbox (the geometry is identical, just denser),
while the trace table grows. Level 3 gives ~406k triangles, a trace table of
~75 MB: larger than an H100's 50 MB L2, so traversal streams from HBM.

Usage: python tools/make_bigscene.py [levels] [out.obj]
  levels=3 (default): 6,348 tris -> 406,272 tris, written to
  scenes/generated/cbox_l<levels>.obj (listed in .gitignore).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hijiki.scene.cbox_mesh import CBOX_OBJ  # noqa: E402

SRC = CBOX_OBJ


def default_out(levels: int) -> str:
    return os.path.join(REPO, "scenes", "generated", f"cbox_l{levels}.obj")


def make_bigscene(levels: int = 3, out: str = "") -> str:
    """Write the ``levels``-times subdivided cbox; returns the OBJ path."""
    out = out or default_out(levels)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    # parse: keep v/vn/vt pools and faces as (mtl, [(vi, ti, ni), ...])
    vs, vts, vns = [], [], []
    faces = []  # (usemtl-name, [(vi, ti, ni) x3]) with None for absent
    cur_mtl = None
    mtllib = None
    for line in open(SRC):
        p = line.split()
        if not p:
            continue
        if p[0] == "v":
            vs.append([float(x) for x in p[1:4]])
        elif p[0] == "vt":
            vts.append([float(x) for x in p[1:3]])
        elif p[0] == "vn":
            vns.append([float(x) for x in p[1:4]])
        elif p[0] == "mtllib":
            mtllib = p[1]
        elif p[0] == "usemtl":
            cur_mtl = p[1]
        elif p[0] == "f":
            idx = []
            for tok in p[1:]:
                parts = tok.split("/")
                vi = int(parts[0])
                ti = int(parts[1]) if len(parts) > 1 and parts[1] else None
                ni = int(parts[2]) if len(parts) > 2 and parts[2] else None
                idx.append((vi, ti, ni))
            # fan-triangulate like the loaders do
            for k in range(1, len(idx) - 1):
                faces.append((cur_mtl, [idx[0], idx[k], idx[k + 1]]))

    def mid_pool(pool, cache, a, b):
        """Index (1-based) of the midpoint of pool[a-1], pool[b-1]."""
        key = (min(a, b), max(a, b))
        if key not in cache:
            pa, pb = pool[a - 1], pool[b - 1]
            pool.append([(x + y) * 0.5 for x, y in zip(pa, pb)])
            cache[key] = len(pool)
        return cache[key]

    for _ in range(levels):
        vc, tc, nc = {}, {}, {}
        new_faces = []
        for mtl, tri in faces:
            (v0, t0, n0), (v1, t1, n1), (v2, t2, n2) = tri
            m01 = mid_pool(vs, vc, v0, v1)
            m12 = mid_pool(vs, vc, v1, v2)
            m20 = mid_pool(vs, vc, v2, v0)
            tm01 = mid_pool(vts, tc, t0, t1) if t0 and t1 else None
            tm12 = mid_pool(vts, tc, t1, t2) if t1 and t2 else None
            tm20 = mid_pool(vts, tc, t2, t0) if t2 and t0 else None
            nm01 = mid_pool(vns, nc, n0, n1) if n0 and n1 else None
            nm12 = mid_pool(vns, nc, n1, n2) if n1 and n2 else None
            nm20 = mid_pool(vns, nc, n2, n0) if n2 and n0 else None
            new_faces += [
                (mtl, [(v0, t0, n0), (m01, tm01, nm01), (m20, tm20, nm20)]),
                (mtl, [(m01, tm01, nm01), (v1, t1, n1), (m12, tm12, nm12)]),
                (mtl, [(m20, tm20, nm20), (m12, tm12, nm12), (v2, t2, n2)]),
                (mtl, [(m01, tm01, nm01), (m12, tm12, nm12), (m20, tm20, nm20)]),
            ]
        faces = new_faces

    with open(out, "w") as f:
        f.write(f"# cbox subdivided x{levels} ({len(faces)} tris)\n")
        if mtllib:
            f.write(f"mtllib {mtllib}\n")
        for v in vs:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for t in vts:
            f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        for n in vns:
            f.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        cur = None
        for mtl, tri in faces:
            if mtl != cur:
                f.write(f"usemtl {mtl}\n")
                cur = mtl
            toks = []
            for vi, ti, ni in tri:
                if ti and ni:
                    toks.append(f"{vi}/{ti}/{ni}")
                elif ni:
                    toks.append(f"{vi}//{ni}")
                elif ti:
                    toks.append(f"{vi}/{ti}")
                else:
                    toks.append(str(vi))
            f.write("f " + " ".join(toks) + "\n")

    # the mtl must sit beside the obj
    mtl_src = os.path.join(os.path.dirname(SRC), mtllib)
    mtl_dst = os.path.join(os.path.dirname(os.path.abspath(out)), mtllib)
    if os.path.abspath(mtl_src) != os.path.abspath(mtl_dst):
        with open(mtl_src) as a, open(mtl_dst, "w") as b:
            b.write(a.read())
    print(f"{out}: {len(faces)} triangles, {len(vs)} positions")
    return out


if __name__ == "__main__":
    make_bigscene(
        int(sys.argv[1]) if len(sys.argv) > 1 else 3,
        sys.argv[2] if len(sys.argv) > 2 else "",
    )
