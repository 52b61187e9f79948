"""Sky-position (RA/Dec) encoders (port of ``sky_embeddings_tpu/models/location.py``).

A closed-form real spherical-harmonics basis over the celestial sphere feeds
a small neural head (SIREN sine-MLP, residual FCNet, or plain linear).

Conventions (as the JAX module):
* inputs are (ra, dec) in degrees; phi = deg2rad(ra), theta = deg2rad(dec+90)
* output channel order is (l, m) for l in 0..L-1, m in -l..l  ->  L² channels
* real SH with Condon-Shortley phase folded into the Legendre recurrence.

Submodules carry flax's auto-names (``SirenNet_0/SirenLayer_0/Dense_0``,
``ResBlock_0``, ...), so a state dict maps onto the JAX ``ra_dec_embed``
params leaf for leaf (``models/weights.py``). Everything runs in fp32, as
the JAX module does (its Dense layers take no dtype).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _assoc_legendre(l: int, m: int, x: torch.Tensor) -> torch.Tensor:
    """Associated Legendre polynomial P_l^m(x), m >= 0, Condon-Shortley phase
    (seed P_m^m, step to P_{m+1}^m, then raise l)."""
    pmm = torch.ones_like(x)
    if m > 0:
        somx2 = torch.sqrt((1.0 - x) * (1.0 + x))
        fact = 1.0
        for _ in range(m):
            pmm = pmm * (-fact) * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2.0 * m + 1.0) * pmm
    if l == m + 1:
        return pmmp1
    for ll in range(m + 2, l + 1):
        pll = ((2.0 * ll - 1.0) * x * pmmp1 - (ll + m - 1.0) * pmm) / (ll - m)
        pmm, pmmp1 = pmmp1, pll
    return pmmp1


def _sh_norm(l: int, m: int) -> float:
    return math.sqrt(
        (2.0 * l + 1.0) * math.factorial(l - m) / (4.0 * math.pi * math.factorial(l + m))
    )


def real_spherical_harmonics(ra_dec_deg: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis of (..., 2) RA/Dec degrees -> (..., degree²) features."""
    phi = torch.deg2rad(ra_dec_deg[..., 0])
    theta = torch.deg2rad(ra_dec_deg[..., 1] + 90.0)
    cos_theta = torch.cos(theta)
    feats = []
    for l in range(degree):
        for m in range(-l, l + 1):
            am = abs(m)
            plm = _assoc_legendre(l, am, cos_theta)
            if m == 0:
                y = _sh_norm(l, 0) * plm
            elif m > 0:
                y = math.sqrt(2.0) * _sh_norm(l, m) * torch.cos(m * phi) * plm
            else:
                y = math.sqrt(2.0) * _sh_norm(l, am) * torch.sin(am * phi) * plm
            feats.append(y)
    return torch.stack(feats, dim=-1)


class Dense(nn.Module):
    """flax ``nn.Dense`` in fp32: ``kernel`` (in, out) and an optional ``bias``.
    ``bounds`` = (kernel, bias) half-widths of the SIREN uniform init; None
    takes flax's default (lecun-normal kernel, zero bias)."""

    def __init__(self, din: int, dout: int, use_bias: bool = True,
                 bounds: tuple[float, float] | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(din, dout))
        self.bias = nn.Parameter(torch.zeros(dout)) if use_bias else None
        self.bounds = bounds

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.bounds is None:
                # variance_scaling(1, fan_in, truncated_normal): std corrected
                # for the cut at two standard deviations
                std = math.sqrt(1.0 / self.kernel.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std, generator=generator)
                if self.bias is not None:
                    self.bias.zero_()
                return
            kb, bb = self.bounds
            self.kernel.uniform_(-kb, kb, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bb, bb, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class SirenLayer(nn.Module):
    """One sine-activated layer: sin(w0 · (Wx + b)). SIREN init: the first
    layer U(±1/fan_in), later ones U(±sqrt(c/fan_in)/w0); as in JAX, the
    bias's "fan_in" is its own width (``_siren_uniform`` reads ``shape[-1]``)."""

    def __init__(self, din: int, features: int, w0: float = 1.0, c: float = 6.0,
                 is_first: bool = False, linear_out: bool = False):
        super().__init__()
        scale = (lambda n: 1.0 / n) if is_first else (lambda n: math.sqrt(c / n) / w0)
        self.w0 = w0
        self.linear_out = linear_out
        self.Dense_0 = Dense(din, features, bounds=(scale(din), scale(features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(x)
        return y if self.linear_out else torch.sin(self.w0 * y)


class SirenNet(nn.Module):
    """SIREN MLP: ``num_layers`` sine layers + linear output (siren-init)."""

    def __init__(self, din: int, hidden_dim: int, out_dim: int, num_layers: int = 1,
                 w0: float = 1.0, w0_initial: float = 30.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"SirenLayer_{i}", SirenLayer(
                din if i == 0 else hidden_dim, hidden_dim,
                w0=w0_initial if i == 0 else w0, is_first=i == 0))
        self.add_module(f"SirenLayer_{num_layers}",
                        SirenLayer(hidden_dim, out_dim, w0=w0, linear_out=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers + 1):
            x = getattr(self, f"SirenLayer_{i}")(x)
        return x


class ResBlock(nn.Module):
    """Residual MLP block of the GeoPrior FCNet."""

    def __init__(self, features: int, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = Dense(features, features)
        self.Dense_1 = Dense(features, features)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        y = F.relu(self.Dense_0(x))
        y = F.dropout(y, self.dropout_rate, training=not deterministic)
        return x + F.relu(self.Dense_1(y))


class FCNet(nn.Module):
    """GeoPrior residual MLP head."""

    def __init__(self, din: int, hidden_dim: int, out_dim: int, num_blocks: int = 4):
        super().__init__()
        self.num_blocks = num_blocks
        self.Dense_0 = Dense(din, hidden_dim)
        for i in range(num_blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(hidden_dim))
        self.Dense_1 = Dense(hidden_dim, out_dim, use_bias=False)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = F.relu(self.Dense_0(x))
        for i in range(self.num_blocks):
            x = getattr(self, f"ResBlock_{i}")(x, deterministic)
        return self.Dense_1(x)


class LocationEncoder(nn.Module):
    """RA/Dec (degrees) -> embedding: SH basis + a neural head. The models'
    defaults: ``head='siren', degree=5, hidden_dim=8, num_layers=1``."""

    def __init__(self, out_dim: int, degree: int = 5, head: str = "siren", hidden_dim: int = 8,
                 num_layers: int = 1):
        super().__init__()
        self.degree = degree
        self.head = head
        n_basis = degree * degree
        if head == "siren":
            self.SirenNet_0 = SirenNet(n_basis, hidden_dim, out_dim, num_layers=num_layers)
        elif head == "fcnet":
            self.FCNet_0 = FCNet(n_basis, hidden_dim, out_dim)
        elif head == "linear":
            self.Dense_0 = Dense(n_basis, out_dim)
        else:
            raise ValueError(f"unknown location-encoder head: {head!r}")

    def forward(self, ra_dec_deg: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        basis = real_spherical_harmonics(ra_dec_deg, self.degree)
        if self.head == "siren":
            return self.SirenNet_0(basis)
        if self.head == "fcnet":
            return self.FCNet_0(basis, deterministic)
        return self.Dense_0(basis)


def normalize_ra_dec(ra_dec: torch.Tensor) -> torch.Tensor:
    """Scale RA [0,360] and Dec [-90,90] to [-1,1]."""
    return torch.stack([ra_dec[..., 0] / 180.0 - 1.0, ra_dec[..., 1] / 90.0], dim=-1)
