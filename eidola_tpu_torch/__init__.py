"""EIDOLA on PyTorch + CUDA: the port of `eidola_tpu` to one NVIDIA H100.

The package mirrors `eidola_tpu/` module for module (`ops/`, `render/`,
`scene/`, `models/`, `app/`, `utils/`), so each function has its
counterpart at the same path and name.  It imports `torch` and never
`jax`; the JAX package stays the reference the port is tested against.

Conventions that differ from the JAX package:
- Every entry point runs on the card unless the caller asks for the CPU
  (`device="cpu"`, `--device cpu`); nothing falls back from CUDA.
- uint32 words (RNG state, octahedral codes, G-buffer words) are carried
  as int64 tensors holding values in [0, 2**32): torch has only partial
  uint32 support and its `>>` on signed ints is arithmetic.

What it renders: the default frame (ReSTIR DI + temporal reuse, ReSTIR
GI with sorted wavefront bounces, a-trous denoise, compose, post) on
flattened and instanced scenes (`ops/bvh_instanced.py`,
`scene/data.upload_scene_instanced`), with the alpha HitTest and the
opaque/alpha BVH split for alpha-tested materials.  Five hand-written
CUDA kernels carry its traversals, each the port of a Pallas kernel,
built with nvcc at first use and run on CUDA tensors only (on a CPU
tensor the wrapper runs its plain-torch version):
- `walk_closest`, `walk_any` (`csrc/bvh_walk.cu`): the one-kernel walk
  over flat and instanced BVHs, every traversal's default on the card;
- `mt_fused`, `mt_any_fused` (`csrc/bvh_fused.cu`): the leaf drains of
  the torch walk (`ops/bvh.py`) under EIDOLA_TRAV=xla;
- `mt_mxu` (`csrc/bvh_mxu.cu`): the per-event closest-hit drain under
  EIDOLA_MT=mxu.
"""

__version__ = "0.1.0"
