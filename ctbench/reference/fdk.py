"""Plain FDK (Feldkamp, Davis, Kress 1984) in float64 PyTorch.

The benchmark's own reference of what a configuration asks for. It
imports nothing of the program: the geometry, the weights and the ramp
filter are worked out again here from the numbers of the configuration
file, and the back-projection is a voxel-driven loop over views with
bilinear interpolation, computed only at the voxel columns the check
samples.

Conventions (those of a centred, circular cone-beam scan):

* The volume is a cube of ``volume`` voxels a side spanning
  ``volume_extent`` world units, centred on the rotation axis; voxel
  ``(i, j, k)`` sits at ``((i, j, k) - (n - 1) / 2) * pitch``, and the
  volume is returned as ``vol[k, j, i]``.
* View ``s`` of ``views`` puts the source at angle ``2 pi s / views`` on
  a circle of radius ``sad``; a flat detector of ``detector`` x
  ``detector`` pixels, ``volume_extent * sdd / sad * detector_pad``
  units across, stands ``sdd`` from the source, its rows parallel to
  the rotation axis.
* FDK: each raw view is cosine-weighted, ramp-filtered row by row with
  the discrete Ram-Lak kernel (Kak & Slaney eq. 61) at the pitch the
  detector has at the axis, and back-projected with the weight
  ``(sad / depth)^2``, the whole scaled by ``dtheta / 2``.
* A sample contributes where both of its bilinear neighbours lie on the
  detector in each direction (``0 <= floor(x) <= nw - 2``, the same for
  rows), and nothing elsewhere.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def pitches(cfg: dict):
    """(voxel pitch, detector pixel pitch) in world units."""
    vox = cfg["volume_extent"] / cfg["volume"]
    det = (cfg["volume_extent"] * cfg["sdd"] / cfg["sad"]
           * cfg["detector_pad"]) / cfg["detector"]
    return vox, det


def view_angles(cfg: dict, device) -> torch.Tensor:
    n = cfg["views"]
    return torch.arange(n, dtype=F64, device=device) * (2.0 * math.pi / n)


def ramp_filter(raw: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Cosine-weight and ramp-filter raw views ``(v, nh, nw)``; returns
    float64 filtered views with the FDK scale folded in."""
    d, dd = cfg["sad"], cfg["sdd"]
    _, du = pitches(cfg)
    nv, nh, nw = raw.shape
    dev = raw.device
    u = (torch.arange(nw, dtype=F64, device=dev) - (nw - 1) / 2.0) * du
    v = (torch.arange(nh, dtype=F64, device=dev) - (nh - 1) / 2.0) * du
    weighted = raw.to(F64) * (dd / torch.sqrt(dd * dd + u[None, :] ** 2
                                              + v[:, None] ** 2))
    # Ram-Lak taps at the detector's pitch scaled to the rotation axis
    tau = du * d / dd
    n = torch.arange(-(nw - 1), nw, dtype=F64, device=dev)
    taps = torch.where(n.remainder(2) == 1, -1.0 / (math.pi * n * tau) ** 2,
                       torch.zeros_like(n))
    taps[nw - 1] = 1.0 / (4.0 * tau * tau)
    # linear convolution of each row with the 2 nw - 1 taps, by an FFT
    # long enough that nothing wraps
    size = 4 * nw
    spec = torch.fft.rfft(weighted, n=size, dim=-1) * \
        torch.fft.rfft(taps, n=size)
    full = torch.fft.irfft(spec, n=size, dim=-1)
    filtered = full[..., nw - 1:2 * nw - 1]
    dtheta = 2.0 * math.pi / cfg["views"]
    return filtered * (0.5 * dtheta * tau)


def backproject_columns(filtered: torch.Tensor, angles: torch.Tensor,
                        cfg: dict, ii: torch.Tensor,
                        jj: torch.Tensor) -> torch.Tensor:
    """Back-project filtered views ``(v, nh, nw)`` taken at ``angles``
    into the voxel columns ``(ii[c], jj[c], every k)``; returns the
    float64 sums ``(c, nz)`` (without the views outside ``filtered``)."""
    d, dd = cfg["sad"], cfg["sdd"]
    n = cfg["volume"]
    vox, du = pitches(cfg)
    nv, nh, nw = filtered.shape
    dev = filtered.device
    px = ((ii.to(F64) - (n - 1) / 2.0) * vox)[None, :]
    py = ((jj.to(F64) - (n - 1) / 2.0) * vox)[None, :]
    pz = ((torch.arange(n, dtype=F64, device=dev) - (n - 1) / 2.0)
          * vox)[None, None, :]
    ct = torch.cos(angles)[:, None]
    st = torch.sin(angles)[:, None]
    depth = d - px * ct - py * st                       # (v, c)
    x = dd * (-px * st + py * ct) / depth / du + (nw - 1) / 2.0
    y = (dd * pz / depth[..., None]) / du + (nh - 1) / 2.0   # (v, c, k)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ok = ((x0 >= 0) & (x0 <= nw - 2) & (depth > 0))[..., None] \
        & (y0 >= 0) & (y0 <= nh - 2)
    fx = (x - x0)[..., None]
    fy = y - y0
    xi = x0.clamp(0, nw - 2).long()[..., None]
    yi = y0.clamp(0, nh - 2).long()
    base = (torch.arange(nv, device=dev)[:, None, None] * (nh * nw)
            + yi * nw + xi)
    flat = filtered.reshape(-1)
    top = flat[base] * (1.0 - fx) + flat[base + 1] * fx
    bottom = flat[base + nw] * (1.0 - fx) + flat[base + nw + 1] * fx
    val = top * (1.0 - fy) + bottom * fy
    w = (d / depth) ** 2
    return torch.where(ok, val * w[..., None], 0.0).sum(0)


def fdk_columns(raw: torch.Tensor, cfg: dict, ii: torch.Tensor,
                jj: torch.Tensor, view_block: int = 8) -> torch.Tensor:
    """FDK of the raw scan ``(views, nh, nw)`` at the voxel columns
    ``(ii, jj)``: a float64 ``(c, nz)`` tensor on ``raw``'s device,
    computed ``view_block`` views at a time so that it fits."""
    angles = view_angles(cfg, raw.device)
    out = torch.zeros((ii.numel(), cfg["volume"]), dtype=F64,
                      device=raw.device)
    for s0 in range(0, cfg["views"], view_block):
        s1 = min(s0 + view_block, cfg["views"])
        out += backproject_columns(ramp_filter(raw[s0:s1], cfg),
                                   angles[s0:s1], cfg, ii, jj)
    return out
