"""Synthetic image content made on the device from a seed: a few large
calls of one ``torch.Generator``, so a run's inputs cost little set-up and
the same seed gives the same images. Each kind of content is a function of
this module, found by the name a configuration gives under ``content``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _field(g: torch.Generator, n: int, h: int, w: int, cell: int) -> torch.Tensor:
    """[n, h, w] float32 smooth noise: unit normals on a grid of ``cell``
    pixels, interpolated bilinearly."""
    coarse = torch.randn((n, 1, h // cell + 2, w // cell + 2), generator=g,
                         device=g.device, dtype=torch.float32)
    up = F.interpolate(coarse, scale_factor=cell, mode="bilinear", align_corners=False)
    return up[:, 0, cell:cell + h, cell:cell + w]


def _rgb8(x: torch.Tensor) -> torch.Tensor:
    return x.round().clamp(0, 255).to(torch.uint8)


def histology(g: torch.Generator, n: int, h: int, w: int) -> torch.Tensor:
    """uint8 [n, h, w, 3] like an H&E-stained tissue slide: pale
    background in gaps of the tissue, eosin-pink stroma with fibres down to
    a few pixels, and dark purple nuclei of 10-20 pixels with grainy
    chromatin, with sensor noise. At q75 its scan holds about 1.4 bits a
    pixel, as HETissueSlide.jpg does (783,426 bytes at 2048x2048)."""
    tissue = torch.sigmoid(3 * _field(g, n, h, w, 256) + 1.5)[..., None]
    fibres = (_field(g, n, h, w, 24) + 0.5 * _field(g, n, h, w, 8)
              + 0.8 * _field(g, n, h, w, 3))[..., None]
    nuclei = torch.sigmoid(6 * (_field(g, n, h, w, 12) - 0.8))[..., None]
    chromatin = _field(g, n, h, w, 3)[..., None]
    dev = g.device
    background = torch.tensor([236.0, 232.0, 240.0], device=dev)
    eosin = torch.tensor([205.0, 125.0, 170.0], device=dev) * (1 - 0.3 * torch.tanh(fibres))
    hematoxylin = torch.tensor([80.0, 50.0, 140.0], device=dev) * (1 + 0.3 * torch.tanh(chromatin))
    stain = (1 - nuclei) * eosin + nuclei * hematoxylin
    noise = 6 * torch.randn((n, h, w, 3), generator=g, device=dev)
    return _rgb8((1 - tissue) * background + tissue * stain + noise)


def photo(g: torch.Generator, n: int, h: int, w: int) -> torch.Tensor:
    """uint8 [n, h, w, 3] with a photograph's statistics: luminance detail
    at every scale down to two pixels, step edges, colour detail, and
    sensor noise. At q90 its scan holds about 4.1 bits a pixel, under the
    ILSVRC-2012 training set's mean of about 5 (115 KB a file at a mean
    469x387), whose files are of mixed quality."""
    lum = 110 + sum(a * _field(g, n, h, w, c) for a, c in
                    ((40, 128), (30, 48), (30, 16), (32, 6), (34, 2)))
    lum = lum + 25 * torch.sign(_field(g, n, h, w, 64))
    a = 25 * _field(g, n, h, w, 96) + 10 * _field(g, n, h, w, 24) + 14 * _field(g, n, h, w, 4)
    b = 25 * _field(g, n, h, w, 96) + 10 * _field(g, n, h, w, 24) + 14 * _field(g, n, h, w, 4)
    rgb = torch.stack([lum + a, lum - 0.5 * a + 0.3 * b, lum - b], dim=-1)
    return _rgb8(rgb + 12 * torch.randn((n, h, w, 3), generator=g, device=g.device))


KINDS = {"histology": histology, "photo": photo}
