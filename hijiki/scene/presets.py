"""Built-in procedural scenes — the framework is standalone, no OBJ assets
required. ``python -m hijiki.cli builtin:cornell`` renders out of the box.

The Cornell box here is built from the classic published Cornell-box layout
(unit-ish box, red/green side walls, area light at the ceiling), expressed
with this framework's native Quad primitive. It is NOT the reference's
``scenes/cbox`` asset (that is a triangle-mesh variant with a teapot); it is
the standard textbook scene, sized to the reference's hardcoded cbox camera
(``src/main.rs:417-425``) so renders frame correctly.
"""

from __future__ import annotations

from hijiki.scene.model import (
    Camera,
    Dielectric,
    Diffuse,
    DiffuseCheckerboard,
    Emissive,
    Mirror,
    Quad,
    Scene,
    Sphere,
)


def cornell_box(
    light_power: float = 15.0,
    spheres: bool = False,
    glass: bool = False,
) -> Scene:
    """Quad-walled Cornell box framed for the cbox default camera.

    Box spans x,z in [-1,1], y in [0,2] with the open side facing +z (the
    camera). Optional mirror/checkerboard spheres mirror the reference's
    ``--put-cbox-spheres`` flavor; ``glass`` adds a clear dielectric sphere.
    """
    s = Scene(camera=Camera.cbox_default())
    white = s.add_material(Diffuse((0.725, 0.71, 0.68)))
    red = s.add_material(Diffuse((0.63, 0.065, 0.05)))
    green = s.add_material(Diffuse((0.14, 0.45, 0.091)))
    light = s.add_material(Emissive((light_power,) * 3))

    # floor, ceiling, back wall, left (red), right (green)
    s.add_object(Quad((-1, 0, -1), (2, 0, 0), (0, 0, 2)), white)
    s.add_object(Quad((-1, 2, -1), (0, 0, 2), (2, 0, 0)), white)
    s.add_object(Quad((-1, 0, -1), (0, 2, 0), (2, 0, 0)), white)
    s.add_object(Quad((-1, 0, -1), (0, 0, 2), (0, 2, 0)), red)
    s.add_object(Quad((1, 0, -1), (0, 2, 0), (0, 0, 2)), green)
    # area light just under the ceiling
    s.add_object(Quad((-0.25, 1.98, -0.25), (0.5, 0, 0), (0, 0, 0.5)), light)

    if spheres:
        mirror = s.add_material(Mirror())
        cb = s.add_material(
            DiffuseCheckerboard((0.8, 0.8, 0.8), 0.1, (0.1, 0.1, 0.1), 0.1)
        )
        s.add_object(Sphere((-0.45, 0.35, 0.2), 0.35), mirror)
        s.add_object(Sphere((0.45, 0.35, -0.2), 0.35), cb)
    if glass:
        diel = s.add_material(Dielectric.clear(1.5))
        s.add_object(Sphere((0.0, 0.35, 0.55), 0.3), diel)
    return s


PRESETS = {
    "cornell": cornell_box,
    "cornell-spheres": lambda: cornell_box(spheres=True),
    "cornell-glass": lambda: cornell_box(spheres=True, glass=True),
}


def load_preset(name: str) -> Scene:
    """Resolve a ``builtin:<name>`` scene."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown builtin scene {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name]()
