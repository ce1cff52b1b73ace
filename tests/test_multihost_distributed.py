"""Genuine two-process multihost run: MultiHostRenderer under a real
jax.distributed coordinator (CPU backend, localhost), exercising the
cross-process process_allgather merge path that the in-process simulations
(tests/test_multichip.py) cannot reach. Each process traces its sweep
stride of the identical schedule; merged_film() must equal the single-host
render up to float summation order (the per-sweep deltas are identical;
only the order of the associative film additions differs)."""

import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]; cls = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.distributed.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
import numpy as np
import hijiki.parallel.multihost as mh
from hijiki.render.renderer import RenderConfig
from hijiki.scene.compile import compile_scene
from hijiki.scene.cbox_mesh import CBOX_OBJ
from hijiki.scene.obj import load_obj_scene

scene = load_obj_scene(CBOX_OBJ)
scene.put_cbox_spheres()
cs = compile_scene(scene)
cfg = RenderConfig(width=32, height=32, spp=3, block_size=64, seed=7,
                   max_bounces=8, driver="sync")
kw = dict(num_devices=2) if cls == "MultiHostMultiChipRenderer" else {}
r = getattr(mh, cls)(cs, cfg, **kw)  # host topology from jax.distributed
assert r.num_hosts == 2 and r.host_id == pid, (r.num_hosts, r.host_id)
r.render()
merged = np.asarray(r.merged_film())
if pid == 0:
    np.save(out, merged)
print("worker", pid, "ok", flush=True)
"""


@pytest.mark.parametrize("cls,port", [
    ("MultiHostRenderer", "43217"),
    # the two-level topology: local 2-device mesh per process + sweep stride
    ("MultiHostMultiChipRenderer", "43219"),
])
def test_two_process_dcn_merge(tmp_path, cls, port):
    out = str(tmp_path / "merged.npy")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(pid), port, out, cls],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    logs = [p.communicate(timeout=540)[0] for p in procs]
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-2000:]}"

    # single-host reference render of the same schedule, in-process
    from hijiki.render.renderer import RenderConfig, Renderer
    from hijiki.scene.compile import compile_scene
    from hijiki.scene.cbox_mesh import CBOX_OBJ
    from hijiki.scene.obj import load_obj_scene

    scene = load_obj_scene(CBOX_OBJ)
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    r = Renderer(
        cs,
        RenderConfig(width=32, height=32, spp=3, block_size=64, seed=7,
                     max_bounces=8, driver="sync"),
    )
    r.render()
    merged = np.load(out)
    # sharded-vs-single FMA/fusion noise (test_multichip tolerances)
    np.testing.assert_allclose(
        merged, np.asarray(r.film), rtol=1e-4, atol=2e-4
    )
