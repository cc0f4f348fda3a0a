"""Fixed-size real DFTs.

Counterpart of ``audioforge_tpu/ops/dft.py``, which wrote the 960-point
transform as matmuls only to suit the TPU's matrix unit; here it is
``torch.fft`` with the same scaling: :func:`rdft` is ``numpy.fft.rfft``
(unscaled forward) and :func:`irdft` is ``numpy.fft.irfft`` (1/n inverse).
The reference's ``rdft_auto`` and ``irdft_auto`` (picking the matmul or the
FFT form by platform) have no counterpart: there is one form here.
"""

from __future__ import annotations

import torch



def rdft(x, n: int):
    """``x: [..., n]`` real -> complex ``[..., n//2 + 1]``."""
    if x.shape[-1] != n:
        raise ValueError(f"expected last axis {n}, got {x.shape[-1]}")
    return torch.fft.rfft(x, n=n, dim=-1)


def irdft(X, n: int):
    """``X: [..., n//2 + 1]`` complex -> real ``[..., n]``."""
    if X.shape[-1] != n // 2 + 1:
        raise ValueError(f"expected last axis {n // 2 + 1}, got {X.shape[-1]}")
    return torch.fft.irfft(X, n=n, dim=-1)
