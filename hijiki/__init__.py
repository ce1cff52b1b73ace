"""hijiki: a wavefront Monte-Carlo path tracer in JAX/XLA.

Library quick start::

    from hijiki import RenderConfig, Renderer, compile_scene, load_preset
    scene = load_preset("cornell-spheres")       # or load_obj_scene(path)
    r = Renderer(compile_scene(scene),
                 RenderConfig(width=512, height=512, spp=64))
    r.render()
    image = r.image()                            # (H, W, 3) float RGB

The CLI twin: ``python -m hijiki.cli --help``.
"""

from hijiki.parallel.multichip import MultiChipRenderer
from hijiki.parallel.multihost import MultiHostRenderer
from hijiki.render.renderer import RenderConfig, Renderer, render_sweep
from hijiki.scene.compile import CompiledScene, compile_scene
from hijiki.scene.obj import load_obj_scene
from hijiki.scene.presets import load_preset

__all__ = [
    "CompiledScene",
    "MultiChipRenderer",
    "MultiHostRenderer",
    "RenderConfig",
    "Renderer",
    "compile_scene",
    "load_obj_scene",
    "load_preset",
    "render_sweep",
]
