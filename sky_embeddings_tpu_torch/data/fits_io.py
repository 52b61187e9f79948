"""Minimal self-contained FITS image I/O + TAN WCS (framework-free copy of
``sky_embeddings_tpu/data/fits_io.py``; the notes below are the original's).

The reference reads survey tiles with astropy (``utils/dataloaders.py:
382-448``: ``hdul[1].data`` plus a WCS pixel→sky closure). astropy is not
available in this environment, so this module implements the small subset of
the FITS standard the pipeline needs, with no dependencies beyond numpy:

* reading: primary + IMAGE-extension HDUs, BITPIX ∈ {8,16,32,64,-32,-64},
  BSCALE/BZERO, big-endian data, END-card/2880-byte block framing;
* writing (for tests/fixtures and dataset engineering): single-image HDUs
  with minimal headers;
* ``TanWCS``: the gnomonic (TAN) celestial projection — pixel→(ra, dec) and
  inverse — from CRPIX/CRVAL/CD (or CDELT) cards, LONPOLE=180 convention
  (FITS-WCS paper II formulas).

Compressed (fpack/RICE) HDUs are out of scope and raise a clear error.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


def _parse_card(card: str):
    key = card[:8].strip()
    if key in ("COMMENT", "HISTORY", "END", ""):
        return key, None
    if card[8:10] != "= ":
        return key, None
    raw = card[10:]
    # strip inline comment (outside of strings)
    if raw.lstrip().startswith("'"):
        s = raw.lstrip()
        end = s.find("'", 1)
        while end != -1 and end + 1 < len(s) and s[end + 1] == "'":
            end = s.find("'", end + 2)
        value = s[1:end].replace("''", "'").rstrip()
        return key, value
    if "/" in raw:
        raw = raw.split("/", 1)[0]
    raw = raw.strip()
    if raw in ("T", "F"):
        return key, raw == "T"
    try:
        if any(c in raw for c in ".EeDd") and not raw.lstrip("+-").isdigit():
            return key, float(raw.replace("D", "E").replace("d", "e"))
        return key, int(raw)
    except ValueError:
        return key, raw


def _read_header(f) -> Optional[dict]:
    header: dict = {}
    while True:
        block = f.read(BLOCK)
        if not block:
            return None if not header else header
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header block")
        text = block.decode("ascii", errors="replace")
        for i in range(0, BLOCK, CARD):
            card = text[i : i + CARD]
            key, value = _parse_card(card)
            if key == "END":
                return header
            if key and value is not None and key not in header:
                header[key] = value


def _data_size(header: dict) -> int:
    naxis = int(header.get("NAXIS", 0))
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= int(header[f"NAXIS{i}"])
    bitpix = abs(int(header["BITPIX"]))
    # binary tables add heap space
    n_bytes = n * bitpix // 8
    n_bytes += int(header.get("PCOUNT", 0)) * (1 if header.get("XTENSION") else 0)
    return n_bytes


def read_fits(path: str) -> list[tuple[dict, Optional[np.ndarray]]]:
    """Read all HDUs: list of (header, data-or-None). Image HDUs get numpy
    arrays (native byte order, float32 for scaled ints); table HDUs get None.
    """
    hdus = []
    with open(path, "rb") as f:
        while True:
            header = _read_header(f)
            if header is None:
                break
            size = _data_size(header)
            padded = (size + BLOCK - 1) // BLOCK * BLOCK
            xtension = str(header.get("XTENSION", "")).strip().upper()
            is_image = (not xtension and header.get("SIMPLE") is not None) or (
                xtension == "IMAGE"
            )
            if is_image and size > 0:
                if "ZIMAGE" in header:
                    raise ValueError(
                        f"{path}: tile-compressed FITS (fpack) is not supported; "
                        "funpack the file first"
                    )
                raw = f.read(size)
                if len(raw) < size:
                    raise ValueError(f"{path}: truncated data unit")
                f.read(padded - size)
                bitpix = int(header["BITPIX"])
                arr = np.frombuffer(raw, dtype=_BITPIX_DTYPE[bitpix])
                shape = tuple(
                    int(header[f"NAXIS{i}"])
                    for i in range(int(header["NAXIS"]), 0, -1)
                )
                arr = arr.reshape(shape)
                bscale = header.get("BSCALE", 1)
                bzero = header.get("BZERO", 0)
                if bscale != 1 or bzero != 0:
                    arr = arr.astype(np.float32) * bscale + bzero
                else:
                    arr = arr.astype(arr.dtype.newbyteorder("="))
                hdus.append((header, arr))
            else:
                f.seek(padded, 1)
                hdus.append((header, None))
    return hdus


def read_image(path: str, hdu: Optional[int] = None) -> tuple[np.ndarray, dict]:
    """Read one image HDU (default: HDU 1 if it has data, else HDU 0 —
    mirroring the reference's ``hdul[1].data`` access for calexp files)."""
    hdus = read_fits(path)
    if hdu is not None:
        header, data = hdus[hdu]
        if data is None:
            raise ValueError(f"{path} HDU {hdu} has no image data")
        return data, header
    for idx in (1, 0):
        if idx < len(hdus) and hdus[idx][1] is not None:
            return hdus[idx][1], hdus[idx][0]
    raise ValueError(f"{path}: no image HDU found")


# ----------------------------------------------------------------------
# Writing (fixtures + offline data engineering)
# ----------------------------------------------------------------------

def _format_card(key: str, value) -> str:
    if isinstance(value, bool):
        v = "T" if value else "F"
        return f"{key:<8}= {v:>20}".ljust(CARD)
    if isinstance(value, (int, np.integer)):
        return f"{key:<8}= {value:>20}".ljust(CARD)
    if isinstance(value, (float, np.floating)):
        return f"{key:<8}= {value:>20.12E}".ljust(CARD)
    return f"{key:<8}= '{value}'".ljust(CARD)


def write_image(path: str, data: np.ndarray, wcs_cards: Optional[dict] = None) -> str:
    """Write a single-HDU float32 FITS image (+ optional WCS cards)."""
    data = np.ascontiguousarray(data, dtype=">f4")
    cards = [
        _format_card("SIMPLE", True),
        _format_card("BITPIX", -32),
        _format_card("NAXIS", data.ndim),
    ]
    for i, n in enumerate(reversed(data.shape), start=1):
        cards.append(_format_card(f"NAXIS{i}", int(n)))
    for key, value in (wcs_cards or {}).items():
        cards.append(_format_card(key, value))
    cards.append("END".ljust(CARD))
    header = "".join(cards)
    header += " " * ((-len(header)) % BLOCK)
    payload = data.tobytes()
    payload += b"\x00" * ((-len(payload)) % BLOCK)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)
    return path


# ----------------------------------------------------------------------
# TAN WCS
# ----------------------------------------------------------------------

class TanWCS:
    """Gnomonic projection: 0-based pixel coords ↔ (RA, Dec) degrees."""

    def __init__(self, crpix, crval, cd):
        self.crpix = np.asarray(crpix, dtype=np.float64)  # 1-based FITS CRPIX
        self.crval = np.asarray(crval, dtype=np.float64)
        self.cd = np.asarray(cd, dtype=np.float64).reshape(2, 2)

    @classmethod
    def from_header(cls, header: dict) -> "TanWCS":
        ctype1 = str(header.get("CTYPE1", "RA---TAN"))
        if "TAN" not in ctype1:
            raise ValueError(f"only TAN projection supported, got {ctype1}")
        crpix = [header.get("CRPIX1", 1.0), header.get("CRPIX2", 1.0)]
        crval = [header.get("CRVAL1", 0.0), header.get("CRVAL2", 0.0)]
        if "CD1_1" in header:
            cd = [
                [header["CD1_1"], header.get("CD1_2", 0.0)],
                [header.get("CD2_1", 0.0), header["CD2_2"]],
            ]
        else:
            cdelt1 = header.get("CDELT1", 1.0)
            cdelt2 = header.get("CDELT2", 1.0)
            pc11 = header.get("PC1_1", 1.0)
            pc12 = header.get("PC1_2", 0.0)
            pc21 = header.get("PC2_1", 0.0)
            pc22 = header.get("PC2_2", 1.0)
            cd = [[cdelt1 * pc11, cdelt1 * pc12], [cdelt2 * pc21, cdelt2 * pc22]]
        return cls(crpix, crval, cd)

    def to_cards(self) -> dict:
        return {
            "CTYPE1": "RA---TAN",
            "CTYPE2": "DEC--TAN",
            "CRPIX1": float(self.crpix[0]),
            "CRPIX2": float(self.crpix[1]),
            "CRVAL1": float(self.crval[0]),
            "CRVAL2": float(self.crval[1]),
            "CD1_1": float(self.cd[0, 0]),
            "CD1_2": float(self.cd[0, 1]),
            "CD2_1": float(self.cd[1, 0]),
            "CD2_2": float(self.cd[1, 1]),
        }

    def pixel_to_world(self, x, y):
        """0-based pixel (x, y) -> (ra, dec) degrees. Vectorized."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        dx = x + 1.0 - self.crpix[0]
        dy = y + 1.0 - self.crpix[1]
        u = self.cd[0, 0] * dx + self.cd[0, 1] * dy  # deg
        v = self.cd[1, 0] * dx + self.cd[1, 1] * dy

        ur = np.deg2rad(u)
        vr = np.deg2rad(v)
        r = np.hypot(ur, vr)
        # native spherical coords (theta from pole), phi per WCS paper II
        theta = np.where(r > 0, np.arctan2(1.0, r), np.pi / 2)
        phi = np.arctan2(ur, -vr)

        a0 = math.radians(self.crval[0])
        d0 = math.radians(self.crval[1])
        # celestial rotation with LONPOLE = 180 deg
        sin_t, cos_t = np.sin(theta), np.cos(theta)
        cos_dphi = np.cos(phi - math.pi)
        sin_dphi = np.sin(phi - math.pi)
        dec = np.arcsin(sin_t * math.sin(d0) + cos_t * math.cos(d0) * cos_dphi)
        ra = a0 + np.arctan2(
            -cos_t * sin_dphi, sin_t * math.cos(d0) - cos_t * math.sin(d0) * cos_dphi
        )
        return np.rad2deg(ra) % 360.0, np.rad2deg(dec)

    def world_to_pixel(self, ra, dec):
        """(ra, dec) degrees -> 0-based pixel (x, y). Vectorized."""
        ra = np.deg2rad(np.asarray(ra, dtype=np.float64))
        dec = np.deg2rad(np.asarray(dec, dtype=np.float64))
        a0 = math.radians(self.crval[0])
        d0 = math.radians(self.crval[1])
        da = ra - a0
        sin_t = np.sin(dec) * math.sin(d0) + np.cos(dec) * math.cos(d0) * np.cos(da)
        # native coords
        y_n = np.sin(dec) * math.cos(d0) - np.cos(dec) * math.sin(d0) * np.cos(da)
        x_n = -np.cos(dec) * np.sin(da)
        phi = math.pi + np.arctan2(x_n, y_n)
        # (x_n, y_n, sin_t) is a unit vector -> cos(theta) = hypot(x_n, y_n)
        # (numerically better than sqrt(1 - sin²) near the tangent point)
        cos_t = np.hypot(x_n, y_n)
        r = cos_t / np.maximum(sin_t, 1e-12)  # cot(theta), radians
        u = np.rad2deg(r * np.sin(phi))
        v = np.rad2deg(-r * np.cos(phi))
        inv = np.linalg.inv(self.cd)
        dx = inv[0, 0] * u + inv[0, 1] * v
        dy = inv[1, 0] * u + inv[1, 1] * v
        return dx + self.crpix[0] - 1.0, dy + self.crpix[1] - 1.0
