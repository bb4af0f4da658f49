"""The reference's scenes, one module a scene, found by the name that a
configuration's `scene` gives (scene.make): `<name>.py` exposes
`make(*, device, **scene_args) -> scene.Standin` and says in its
docstring what it was written from."""
