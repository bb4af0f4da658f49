"""The reference's scenes, one module a scene, found by the name that a
configuration's `scene` gives (scene.make): `<name>.py` exposes
`make(*, device, **scene_args) -> scene.Standin`, whose `light` names a
light of lights/ and its arguments, and says in its docstring what it
was written from."""
