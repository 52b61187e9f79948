"""Concatenate HDF5 cutout files (port of
``sky_embeddings_tpu/data_processing/combine.py``, reference
``3_combine_h5_files.py``)."""

from __future__ import annotations

from typing import Sequence

from sky_embeddings_tpu_torch.data_processing import require_h5py


def combine_h5_files(inputs: Sequence[str], out_path: str, batch: int = 4096) -> str:
    """Stream-concatenate the keys of the first input from all inputs into
    one file of resizable datasets."""
    h5py = require_h5py()
    with h5py.File(inputs[0], "r") as f:
        keys = list(f.keys())

    with h5py.File(out_path, "w") as out:
        for path in inputs:
            with h5py.File(path, "r") as f:
                n = f[keys[0]].shape[0]
                for start in range(0, n, batch):
                    end = min(n, start + batch)
                    for k in keys:
                        arr = f[k][start:end]
                        if k not in out:
                            out.create_dataset(
                                k, data=arr, maxshape=(None,) + arr.shape[1:],
                                chunks=(min(len(arr), 256),) + arr.shape[1:],
                            )
                        else:
                            ds = out[k]
                            n0 = ds.shape[0]
                            ds.resize(n0 + len(arr), axis=0)
                            ds[n0:] = arr
    return out_path


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser("Combine h5 cutout files")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--out_path", required=True)
    args = p.parse_args(argv)
    combine_h5_files(args.inputs, args.out_path)


if __name__ == "__main__":  # pragma: no cover
    main()
