"""The reference's lights, one module a kind, found by the kind that a
scene's `light` names (light.make): `<kind>.py` exposes
`make(*, device, num, **light_args)`, an object with `sample(u1, u2, u3,
u4) -> (wi, pdf, li)`, `radiance(d)` and `pdf(d)`, and says in its
docstring what it was written from."""
