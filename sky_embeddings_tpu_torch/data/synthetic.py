"""Synthetic HDF5 fixtures with the survey-cutout schema.

Copy of ``make_cutouts`` / ``write_synthetic_h5`` and of the structured
survey (``make_structured_cutouts`` / ``write_structured_h5``, class- and
redshift-structured cutouts for the linear probes) from
``sky_embeddings_tpu/data/synthetic.py``; the same seed gives the same
arrays, bit for bit. Schema:

    cutouts    (N, C, S, S) float32
    ra         (N,) float
    dec        (N,) float
    zspec      (N,) float
    zspec_err  (N,) float
    class      (N,) int   (classifier sets only)

``make_cutouts`` draws exponential-profile blobs plus noise, with an
optional fraction of whole bands set to NaN (missing bands).
``structured_survey`` returns in memory the arrays that
``write_structured_h5`` writes with the same arguments (the same chunks and
chunk seeds), for hosts without h5py.
"""

from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - hosts without h5py use make_cutouts only
    h5py = None


def make_cutouts(
    n: int,
    channels: int = 5,
    img_size: int = 64,
    nan_band_frac: float = 0.1,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Build an in-memory synthetic dataset dict (schema above)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    cy = cx = (img_size - 1) / 2.0

    amp = rng.lognormal(mean=0.0, sigma=0.8, size=(n, 1, 1, 1)).astype(np.float32)
    radius = rng.uniform(1.5, 6.0, size=(n, 1, 1, 1)).astype(np.float32)
    band_scale = rng.uniform(0.5, 1.5, size=(n, channels, 1, 1)).astype(np.float32)
    r2 = ((yy - cy) ** 2 + (xx - cx) ** 2)[None, None]
    profile = amp * band_scale * np.exp(-np.sqrt(r2) / radius)
    noise = rng.normal(0.0, 0.05, size=(n, channels, img_size, img_size)).astype(np.float32)
    cutouts = (profile + noise).astype(np.float32)

    if nan_band_frac > 0:
        drop = rng.random((n, channels)) < nan_band_frac
        cutouts[drop] = np.nan

    zspec = rng.uniform(0.05, 1.6, size=n).astype(np.float32)
    return {
        "cutouts": cutouts,
        "ra": rng.uniform(0.0, 360.0, size=n).astype(np.float32),
        "dec": rng.uniform(-20.0, 60.0, size=n).astype(np.float32),
        "zspec": zspec,
        "zspec_err": (0.01 + 0.05 * rng.random(n) * zspec).astype(np.float32),
        "class": rng.integers(0, 3, size=n).astype(np.int64),
    }


def write_synthetic_h5(
    path: str,
    n: int,
    channels: int = 5,
    img_size: int = 64,
    nan_band_frac: float = 0.1,
    seed: int = 0,
    include_class: bool = True,
) -> str:
    """Write a synthetic dataset file; returns the path."""
    if h5py is None:
        raise ImportError("h5py is required to write synthetic datasets")
    data = make_cutouts(n, channels, img_size, nan_band_frac, seed)
    with h5py.File(path, "w") as f:
        for key, arr in data.items():
            if key == "class" and not include_class:
                continue
            # chunk by row groups so batched reads stream contiguously
            chunks = (min(n, 256),) + arr.shape[1:]
            f.create_dataset(key, data=arr, chunks=chunks)
    return path


# ---------------------------------------------------------------------------
# Structured synthetic survey: class- and redshift-structured cutouts.
#
# The plain ``make_cutouts`` Gaussians can show a loss declining but carry no
# semantics — a probe can never rise on them. This generator plants the two
# signals the real HSC pipeline learns (reference probe protocol
# ``utils/pretrain_fns.py:52-159``, ``README.md:59``):
#
# * morphology by class — Sersic-profile galaxies (elliptical, PSF-blurred)
#   vs PSF point sources (stars and QSOs share the seeing profile, so the
#   star/QSO split is color-only, as on the real sky);
# * band colors carry redshift — each class has a rest-frame SED sampled at
#   the observed band centers / (1+z): galaxies get a 4000 A-style break
#   that marches through the bands with z, QSOs a blue power law + emission
#   lines; stars are z=0 blackbodies with a temperature spread.
#
# Plus the survey's nuisances: lognormal flux (wide S/N spread), per-image
# seeing, NaN'd whole bands, and per-band sky noise.
# ---------------------------------------------------------------------------

#: observed band centers in nm (grizy-like); other channel counts
#: interpolate across the same range
def _band_centers(channels: int) -> np.ndarray:
    if channels == 5:
        return np.array([475.0, 620.0, 770.0, 890.0, 1000.0], np.float32)
    return np.linspace(475.0, 1000.0, channels).astype(np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _galaxy_sed(lam_rest):
    """Old-population galaxy: flux step across the 400 nm (4000 A) break."""
    return 0.15 + 0.85 * _sigmoid((lam_rest - 400.0) / 25.0)


def _qso_sed(lam_rest):
    """Blue power-law continuum + two broad emission lines (MgII-like at
    280 nm, Hbeta/OIII-like at 490 nm)."""
    cont = (lam_rest / 500.0) ** -0.5
    line1 = 0.9 * np.exp(-0.5 * ((lam_rest - 280.0) / 12.0) ** 2)
    line2 = 0.5 * np.exp(-0.5 * ((lam_rest - 490.0) / 15.0) ** 2)
    return 0.6 * cont + line1 + line2


def _star_sed(lam_obs, temp):
    """Blackbody-shaped colors; ``temp`` (n,1) K, ``lam_obs`` (C,) nm."""
    x = 1.4388e7 / (lam_obs[None, :] * temp)  # hc/(lambda k T)
    b = (1000.0 / lam_obs[None, :]) ** 5 / np.expm1(np.clip(x, 1e-3, 50.0))
    return b / b.max(axis=1, keepdims=True)


def _gaussian_blur(stack: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur of an (N, H, W) stack (seeing convolution).
    FFT-free direct 1D convolutions — no scipy dependency."""
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    H, W = stack.shape[1], stack.shape[2]
    padded = np.pad(stack, [(0, 0), (radius, radius), (0, 0)], mode="edge")
    out = sum(k[i] * padded[:, i:i + H, :] for i in range(len(k)))
    padded = np.pad(out, [(0, 0), (0, 0), (radius, radius)], mode="edge")
    return sum(k[i] * padded[:, :, i:i + W] for i in range(len(k)))


def _sersic_morphology(rng, n_obj, img_size, z, seeing_sigma):
    """(n_obj, H, W) PSF-blurred elliptical Sersic profiles, peak ~1.
    Angular size shrinks with redshift (r_e ∝ (1+z)^-1.2)."""
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    cy = cx = (img_size - 1) / 2.0
    jitter = rng.uniform(-1.5, 1.5, size=(n_obj, 2)).astype(np.float32)
    ns = rng.uniform(0.8, 4.0, size=(n_obj, 1, 1)).astype(np.float32)
    # physical size is resolution-relative (2.5-9 px at the survey's 64 px)
    r_phys = (rng.uniform(2.5, 9.0, size=n_obj) * (img_size / 64.0)).astype(np.float32)
    r_e = (r_phys / (1.0 + z) ** 1.2)[:, None, None]
    q = rng.uniform(0.4, 1.0, size=(n_obj, 1, 1)).astype(np.float32)
    theta = rng.uniform(0.0, np.pi, size=(n_obj, 1, 1)).astype(np.float32)

    dy = yy[None] - (cy + jitter[:, 0, None, None])
    dx = xx[None] - (cx + jitter[:, 1, None, None])
    u = dx * np.cos(theta) + dy * np.sin(theta)
    v = -dx * np.sin(theta) + dy * np.cos(theta)
    r = np.sqrt(u ** 2 + (v / q) ** 2, dtype=np.float32) + np.float32(1e-6)
    b_n = (2.0 * ns - 1.0 / 3.0).astype(np.float32)
    prof = np.exp(-b_n * ((r / r_e) ** (1.0 / ns) - 1.0), dtype=np.float32)
    prof /= prof.max(axis=(1, 2), keepdims=True)

    # seeing: bucket per-image sigma into a few discrete values so the blur
    # stays a batched stack operation
    out = np.empty_like(prof)
    buckets = np.clip(np.round(seeing_sigma / 0.35).astype(int), 3, 6)
    for b in np.unique(buckets):
        sel = buckets == b
        out[sel] = _gaussian_blur(prof[sel], b * 0.35)
    peak = out.max(axis=(1, 2), keepdims=True)
    return out / np.maximum(peak, 1e-6)


def _point_morphology(rng, n_obj, img_size, seeing_sigma):
    """(n_obj, H, W) Gaussian PSF point sources, peak 1."""
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    cy = cx = (img_size - 1) / 2.0
    jitter = rng.uniform(-1.0, 1.0, size=(n_obj, 2)).astype(np.float32)
    s = seeing_sigma[:, None, None]
    dy = yy[None] - (cy + jitter[:, 0, None, None])
    dx = xx[None] - (cx + jitter[:, 1, None, None])
    return np.exp(-0.5 * (dy ** 2 + dx ** 2) / s ** 2).astype(np.float32)


def make_structured_cutouts(
    n: int,
    channels: int = 5,
    img_size: int = 64,
    nan_band_frac: float = 0.05,
    seed: int = 0,
    class_fracs: tuple = (1 / 3, 1 / 3, 1 / 3),
    z_range: tuple = (0.05, 1.6),
    noise_sigma: float = 0.06,
) -> dict[str, np.ndarray]:
    """Class/redshift-structured synthetic survey cutouts (schema above).

    Classes: 0=galaxy, 1=qso, 2=star (the reference's confusion-matrix
    order, ``test_predictor.py:109-116``). Stars carry ``zspec = 0``.
    """
    rng = np.random.default_rng(seed)
    fracs = np.asarray(class_fracs, np.float64)
    counts = np.floor(fracs * n).astype(int)
    # flooring remainder goes to the largest-fraction class so a class
    # requested at 0.0 stays absent from the file
    counts[int(np.argmax(fracs))] += n - counts.sum()
    lam = _band_centers(channels)

    cutouts = np.empty((n, channels, img_size, img_size), np.float32)
    labels = np.empty(n, np.int64)
    zspec = np.empty(n, np.float32)

    start = 0
    for cls, n_c in enumerate(counts):
        if n_c == 0:
            continue
        sl = slice(start, start + n_c)
        start += n_c
        labels[sl] = cls
        seeing = rng.uniform(1.2, 2.1, size=n_c).astype(np.float32)
        if cls == 0:  # galaxy
            z = rng.uniform(*z_range, size=n_c).astype(np.float32)
            sed = _galaxy_sed(lam[None, :] / (1.0 + z[:, None]))
            morph = _sersic_morphology(rng, n_c, img_size, z, seeing)
        elif cls == 1:  # qso
            z = rng.uniform(*z_range, size=n_c).astype(np.float32)
            sed = _qso_sed(lam[None, :] / (1.0 + z[:, None]))
            morph = _point_morphology(rng, n_c, img_size, seeing)
        else:  # star
            z = np.zeros(n_c, np.float32)
            temp = rng.uniform(3500.0, 8500.0, size=(n_c, 1)).astype(np.float32)
            sed = _star_sed(lam, temp)
            morph = _point_morphology(rng, n_c, img_size, seeing)
        zspec[sl] = z
        sed = (sed / sed.mean(axis=1, keepdims=True)).astype(np.float32)
        amp = rng.lognormal(mean=0.3, sigma=0.7, size=(n_c, 1, 1, 1)).astype(np.float32)
        flux = (amp * sed[:, :, None, None]) * morph[:, None]
        noise = rng.standard_normal(
            size=(n_c, channels, img_size, img_size), dtype=np.float32
        )
        noise *= noise_sigma
        cutouts[sl] = flux + noise

    if nan_band_frac > 0:
        drop = rng.random((n, channels)) < nan_band_frac
        cutouts[drop] = np.nan

    # shuffle so class blocks do not align with batch boundaries
    perm = rng.permutation(n)
    return {
        "cutouts": cutouts[perm],
        "ra": rng.uniform(0.0, 360.0, size=n).astype(np.float32),
        "dec": rng.uniform(-20.0, 60.0, size=n).astype(np.float32),
        "zspec": zspec[perm],
        "zspec_err": (0.01 + 0.02 * rng.random(n)).astype(np.float32),
        "class": labels[perm],
    }


def structured_survey(
    n: int,
    channels: int = 5,
    img_size: int = 64,
    nan_band_frac: float = 0.05,
    seed: int = 0,
    include_class: bool = True,
    class_fracs: tuple = (1 / 3, 1 / 3, 1 / 3),
    z_range: tuple = (0.05, 1.6),
    chunk: int = 8192,
) -> dict[str, np.ndarray]:
    """The columns of ``write_structured_h5(path, n, ...)``'s file, as arrays:
    chunks of ``chunk`` rows, chunk ``k`` drawn with seed ``seed + 7919 k``."""
    parts = [make_structured_cutouts(min(chunk, n - start), channels, img_size, nan_band_frac,
                                     seed + 7919 * k, class_fracs, z_range)
             for k, start in enumerate(range(0, n, chunk))]
    keys = [k for k in parts[0] if include_class or k != "class"]
    return {k: np.concatenate([p[k] for p in parts]) for k in keys}


def write_structured_h5(
    path: str,
    n: int,
    channels: int = 5,
    img_size: int = 64,
    nan_band_frac: float = 0.05,
    seed: int = 0,
    include_class: bool = True,
    class_fracs: tuple = (1 / 3, 1 / 3, 1 / 3),
    z_range: tuple = (0.05, 1.6),
    chunk: int = 8192,
) -> str:
    """Write a structured synthetic dataset file (chunked generation so
    survey-scale files never hold the whole array in memory)."""
    if h5py is None:
        raise ImportError("h5py is required to write synthetic datasets")
    first = True
    written = 0
    with h5py.File(path, "w") as f:
        part = 0
        while written < n:
            m = min(chunk, n - written)
            data = make_structured_cutouts(
                m, channels, img_size, nan_band_frac, seed + 7919 * part,
                class_fracs, z_range,
            )
            part += 1
            for key, arr in data.items():
                if key == "class" and not include_class:
                    continue
                if first:
                    f.create_dataset(
                        key, data=arr, maxshape=(None,) + arr.shape[1:],
                        chunks=(min(n, 256),) + arr.shape[1:],
                    )
                else:
                    ds = f[key]
                    ds.resize(written + m, axis=0)
                    ds[written:] = arr
            first = False
            written += m
    return path
