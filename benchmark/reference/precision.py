"""The two precisions the reference computes in.

`Precision(control=False)`: float64, every tensor it reads widened on
entry.  `Precision(control=True)`, the check's control: TF32, the step
below the configuration's float32 with TF32 off.  Every tensor a stage
reads, and every result it hands on, is held in TF32 (float32 with the
mantissa rounded to its 10 bits, to nearest even, as a TF32 datapath holds
its operands), and the arithmetic between is float32.
"""
from __future__ import annotations

import torch


def tf32(x):
    """float32 `x` rounded to TF32's 10 mantissa bits, to nearest even;
    infinities and NaNs are kept."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


class Precision:
    def __init__(self, control: bool = False):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def __call__(self, x):
        """`x` as this precision holds it."""
        x = torch.as_tensor(x)
        if not x.is_floating_point():
            x = x.to(torch.float64)
        return tf32(x) if self.control else x.to(torch.float64)

    def mm(self, a, b):
        """a @ b: operands held as this precision holds them."""
        return self(a) @ self(b)
