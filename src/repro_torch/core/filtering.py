"""FDK pre-weighting and ramp filtering (Feldkamp, Davis, Kress 1984).

Back-projection (the paper's kernel) is stage 3 of FDK. Stages 1-2 are:

  1. cosine pre-weighting: p'(u,v) = p(u,v) * d / sqrt(d^2 + u^2 + v^2)
     (u, v physical detector coordinates relative to the center),
  2. row-wise ramp filtering along u (zero-padded FFT, Ram-Lak kernel with
     the standard discrete-space form of Kak & Slaney, eq. 61, NOT the
     naive |w| sampling, which biases DC).

The overall FDK scale (including the 1/2 from the full-circle scan and the
angular step) is folded in here so the back-projector stays exactly the
paper's Listing-1 kernel with weight f^2 = 1/z^2 (the d^2 of the classical
(d/z)^2 FDK weight is also folded into the filter normalization).

The FFTs are ``torch.fft`` (cuFFT on the card): the JAX package leaves
them to XLA and has no kernel of its own here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import CTGeometry


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def ramlak_kernel_spatial(n_taps: int, du: float) -> np.ndarray:
    """Discrete Ram-Lak in the spatial domain (Kak & Slaney eq. 61).

    h[0] = 1/(4 du^2); h[n] = 0 for even n; h[n] = -1/(pi n du)^2 odd n.
    """
    ns = np.arange(-n_taps, n_taps + 1)
    h = np.zeros(ns.shape, dtype=np.float64)
    h[ns == 0] = 1.0 / (4.0 * du * du)
    odd = (ns % 2) != 0
    h[odd] = -1.0 / (np.pi * ns[odd] * du) ** 2
    return h


def fdk_filter_chunk(projections: torch.Tensor, geom: CTGeometry,
                     n_proj_total: int) -> torch.Tensor:
    """Pre-weight + ramp-filter a CHUNK of raw projections (np, nh, nw).

    The filter is row-wise and per-projection independent, so filtering
    any partition of the projection set chunk by chunk equals filtering
    the whole array at once: this is what lets the executor fuse
    filtering into the projection-chunk loop. The only whole-set
    dependence is the FDK angular step ``dtheta = 2*pi / n_proj_total``,
    which therefore must be passed explicitly (the chunk's own leading
    dimension would mis-scale the result). Runs on the projections'
    device and returns float32 there.
    """
    _, nh, nw = projections.shape
    dev = projections.device
    d, D = geom.sad, geom.sdd
    du, dv = geom.det_spacing
    cu = (nw - 1) / 2.0
    cv = (nh - 1) / 2.0
    u = (torch.arange(nw, dtype=torch.float32, device=dev) - cu) * du
    v = (torch.arange(nh, dtype=torch.float32, device=dev) - cv) * dv
    # Cosine weight at the *physical* detector (distance D from source).
    cosw = D / torch.sqrt(D * D + u[None, :] ** 2 + v[:, None] ** 2)
    weighted = projections * cosw[None]

    # FDK is derived on the *virtual detector* at the rotation axis: the
    # ramp must be discretized at the demagnified pitch du' = du * d / D.
    du_virt = float(du) * d / D

    # Row-wise convolution with the discrete ramp via zero-padded FFT.
    pad = _next_pow2(2 * nw)
    h = ramlak_kernel_spatial(nw, du_virt)            # length 2*nw+1
    h_pad = np.zeros(pad, dtype=np.float64)
    h_pad[: nw + 1] = h[nw:]                           # causal part
    h_pad[pad - nw:] = h[:nw]                          # anti-causal wrap
    H = torch.from_numpy(
        np.fft.rfft(h_pad).real.astype(np.float32)).to(dev)  # real, symmetric

    x = torch.fft.rfft(weighted, n=pad, dim=-1)
    filt = torch.fft.irfft(x * H[None, None, :], n=pad, dim=-1)[..., :nw]

    # FDK scale: (1/2) * dtheta * du' * d^2 (d^2 folded here; BP uses 1/z^2).
    dtheta = 2.0 * math.pi / int(n_proj_total)
    scale = 0.5 * dtheta * du_virt * d * d
    return (filt * scale).to(torch.float32)
