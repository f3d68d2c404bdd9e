"""FID sweep over (n_steps x schedule x min_temp) -> fid/{experiment}.csv.

Counterpart of ``scripts/compute_fid.py``. The CSV has the columns
``n_steps,schedule,min_temp,fid`` (pandas' ``to_csv(index=False)``, as the
JAX script writes it and ``scripts/analyze_fids.py`` reads it), written
with the ``csv`` module and rewritten after every row. ``fid.sample=false``
reuses ``samples_path + ".npz"`` truncated to the FID sample count. Over
several ranks (``torchrun``) the feature extraction splits over the mesh
of ``parallel`` and the sampling over all ranks; rank 0 writes the table.
"""

from __future__ import annotations

import csv
from itertools import product

import numpy as np

from ..config.config import Config
from ..config.loader import with_config
from ..core.device import resolve_device
from ..models.from_config import ddpm_from_config
from ..parallel.distributed import initialize_multihost
from ..parallel.mesh import mesh_from_config, rank
from ..utils.data import get_data_tensor
from ..utils.fid import get_compute_fid, get_feature_fn
from ._common import ensure_dirs
from .sample import build_sampler

COLUMNS = ("n_steps", "schedule", "min_temp", "fid")


def write_rows(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=COLUMNS)
        writer.writeheader()
        writer.writerows(rows)


@with_config(parse_args=(__name__ == "__main__"))
def main(config: Config, device=None):
    initialize_multihost(device=device)
    dev = resolve_device(device)
    ensure_dirs("fid", "samples")
    # feature extraction splits over the 'data' axis; moments all-reduce
    mesh = mesh_from_config(config.parallel)
    if mesh is not None:
        print(f"mesh: {dict(mesh.shape)}")
    reference = get_data_tensor(config, train=config.fid.train, device=dev)
    feature_fn, fdim = get_feature_fn(config.dataset_name, device=dev)
    compute_fid = get_compute_fid(reference, feature_fn, fdim, device=dev,
                                  mesh=mesh)
    ddpm = ddpm_from_config(config, pretrained=True, device=dev)

    paths = config.fid.noise_schedule_path or [None] * len(
        config.fid.noise_schedule_type)
    if len(paths) != len(config.fid.noise_schedule_type):
        raise ValueError(
            f"fid.noise_schedule_path has {len(paths)} entries for "
            f"{len(config.fid.noise_schedule_type)} schedule types; a shorter "
            f"list would silently drop sweep rows; pad with null")
    # snapshot once: build_sampler mutates the config (entropy min_temp),
    # which would move experiment_name, and with it this path, between rows
    results_path = config.fid_results_path
    n_fid = config.fid.samples or config.dataset_config.fid_samples
    rows = []
    for n_steps, (schedule, path), min_temp in product(
        config.fid.n_steps,
        zip(config.fid.noise_schedule_type, paths),
        config.fid.min_temp,
    ):
        config.sample.n_steps = n_steps
        config.sample.noise_schedule_type = schedule
        config.sample.noise_schedule_path = path
        config.sample.n_samples = n_fid
        if config.fid.sample:
            sampler = build_sampler(config, ddpm=ddpm, min_temp=min_temp,
                                    device=dev)
            samples = sampler.sample()["x"]
        else:
            # previously saved samples, truncated to the FID sample count
            samples = np.load(config.samples_path + ".npz")["x"][:n_fid]
        fid = compute_fid(samples)
        rows.append(dict(n_steps=n_steps, schedule=schedule,
                         min_temp=min_temp, fid=fid))
        print(rows[-1])
        if rank() == 0:
            write_rows(results_path, rows)
    if rank() == 0:
        print(f"saved {results_path}")
    return rows


if __name__ == "__main__":
    main()
