"""EIDOLA on PyTorch + CUDA: the port of `eidola_tpu` to one NVIDIA H100.

The package mirrors `eidola_tpu/` module for module (`ops/`, `render/`,
`scene/`, `models/`, `app/`, `utils/`), so each function has its
counterpart at the same path and name.  It imports `torch` and never
`jax`; the JAX package stays the reference the port is tested against.

Conventions that differ from the JAX package:
- Every entry point takes an explicit `device`; nothing picks one.
- uint32 words (RNG state, octahedral codes, G-buffer words) are carried
  as int64 tensors holding values in [0, 2**32): torch has only partial
  uint32 support and its `>>` on signed ints is arithmetic.
- The two leaf-drain kernels (`ops/bvh_fused.py`) are hand-written CUDA
  (`csrc/bvh_fused.cu`) built with nvcc at first use; on a CPU tensor the
  wrappers run their plain-torch versions.

This slice covers the direct-lighting frame (`RenderConfig(denoise=False,
indirect_enabled=False)`); GI and denoise raise NotImplementedError.
"""

__version__ = "0.1.0"
