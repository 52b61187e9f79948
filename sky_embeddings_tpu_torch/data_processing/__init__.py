"""Offline data engineering: build the HDF5 cutout datasets from survey FITS
tiles + source catalogs (port of ``sky_embeddings_tpu/data_processing/``,
counterpart of the reference ``data_processing/``).

Pipeline stages (each usable as a function or module CLI), host tools on
numpy and scipy's ``cKDTree`` that take no device; they read FITS through
the port's ``data/fits_io`` and ``data/fits_loader``:

0. ``cross_match.make_class_catalogs`` — per-class CSV catalogs from a
   redshift catalog cross-matched with a class catalog
   (reference ``1_create_csv_files.ipynb``);
1. ``create_h5.create_h5_dataset``  — cut catalog sources from FITS tiles
   into (N, C, S, S) cutouts with ra/dec/zspec[/class] columns
   (reference ``2_create_h5_files.py`` + ``data_processing/utils.py``);
2. ``combine.combine_h5_files``     — concatenate shard files
   (reference ``3_combine_h5_files.py`` / ``combine_h5.py``);
3. ``dedup.deduplicate_h5``         — kd-tree sky-position dedup
   (reference ``3b_remove_duplicates.ipynb``);
4. ``split.split_dataset``          — random train/val/test split
   (reference ``4_split_dataset.py``);
5. ``probe_sets.make_probe_set``    — balanced per-class linear-probe sets
   (reference ``4_linear_probe_datasets.ipynb``);
6. ``resolution.measure_resolution`` — survey pixel scale from WCS headers
   (reference ``resolution.py``).

h5py is imported by the stages that read or write h5 when they run
(:func:`require_h5py`); without it they raise ``ImportError`` and the
others run.
"""


def require_h5py():
    """The ``h5py`` module; ``ImportError("h5py required")`` where it is
    not installed (the card host)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py required") from e
    return h5py
