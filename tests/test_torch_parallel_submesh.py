"""Port parity: a mesh smaller than the world, and the eval hook on every
rank (gloo, CPU, 4 ranks in one launch).

``mesh_from_config`` with an automatic data axis shrinks it to 3 to
divide a batch of 6, so rank 3 is left out. Every rank builds the mesh
(torch makes each sub-group in a call that all ranks of the world enter)
and rank 3 runs the program alone as a replica.

* The mesh: JAX's warning on every rank, ranks 0-2 at their place on a
  data axis of 3, rank 3 holding everything (``data_size`` 1); a mesh of
  all four made after it all-reduces over all four. The ranks run with
  ``TORCH_DIST_INIT_BARRIER=1``, so a group that a rank does not enter
  hangs them and fails the test at the launch's timeout.
* A train loop at batch 6 (2 rows a member rank, dropout 0.1, flips)
  against one process: losses to 1e-4 relative, params and EMA to 1e-5
  absolute (``test_torch_parallel_train.py``'s tolerances); every rank,
  the left-out one too, ends with the same state as rank 0 within them.
* ``make_eval_fn(mesh=)`` on every rank, each in its own working
  directory: only rank 0 writes the grid, which is bitwise one process's
  (its batch of 500 does not split over 3, so every rank samples it
  whole); the FID samples (batch 48) split over the members, whose
  features are all-reduced: FID equal to one process's to 1e-4 relative
  (the samples agree to fp32 rounding) and the same on every rank to
  1e-4 relative (rank 3's comes from its own whole-batch run).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from pdm_tpu_torch.models import lenet as tlenet
from pdm_tpu_torch.utils import logging as tlog
from torch_dist_workers import eval_config, eval_model, launch, run_loop
from torch_port_fixtures import two_torch_threads  # noqa: F401

WORLD = 4


def _flat(tensors):
    return np.concatenate([t.reshape(-1).numpy() for t in tensors.values()])


def _mnist_like(n, seed):
    u8 = np.random.RandomState(seed).randint(0, 256, (n, 1, 32, 32))
    return (u8 * (2.0 / 255.0) - 1.0).astype(np.float32)


def _with_lenet(path):
    os.makedirs(path / "checkpoints")
    model = tlenet.init_lenet(tlenet.LeNet(), torch.Generator().manual_seed(0))
    tlenet.save_lenet(model, str(path / "checkpoints" / "lenet_mnist.npz"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("submesh")
    data = _mnist_like(64, 0)
    np.savez(tmp / "inputs.npz", data=data)
    dirs = [tmp / f"rank{r}" for r in range(WORLD)] + [tmp / "one"]
    for d in dirs:
        _with_lenet(d)
    # c10d's barrier at each group's creation, so that a rank that skips
    # a creation all ranks must enter hangs the suite (and fails it)
    outs = launch("submesh", WORLD, str(tmp), cwd=lambda r: str(dirs[r]),
                  env={"TORCH_DIST_INIT_BARRIER": "1"})
    return dirs, data, outs


def test_mesh_of_three_ranks_of_four(ranks):
    _, _, outs = ranks
    for r, out in enumerate(outs):
        assert bool(out["warned"])
        want = [3, 3, r] if r < 3 else [3, 1, 0]
        np.testing.assert_array_equal(out["mesh"], want)
        # a mesh of all four made after it adds up over all of them
        np.testing.assert_array_equal(out["whole"], [10.0, 10.0])


def test_train_loop_on_a_mesh_smaller_than_the_world(ranks):
    _, _, outs = ranks
    _, _, logged, p, e = run_loop("dp", batch_size=6)
    loss = np.asarray([logged[k] for k in sorted(logged)])
    for out in outs:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-4)
        np.testing.assert_allclose(out["p"], _flat(p), rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["e"], _flat(e), rtol=0, atol=1e-5)


def test_eval_hook_on_every_rank(ranks, monkeypatch):
    dirs, data, outs = ranks
    monkeypatch.chdir(dirs[-1])
    eval_fn = tlog.make_eval_fn(eval_config(), torch.from_numpy(data),
                                sample_dir="ev", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = eval_fn(eval_model(data), 3)["fid_100_steps"]
    grid = os.path.join("ev", "step_3.png")
    assert (dirs[0] / grid).exists()
    assert not any((d / grid).exists() for d in dirs[1:WORLD])
    np.testing.assert_array_equal(tlog.read_png(str(dirs[0] / grid)),
                                  tlog.read_png(grid))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(float(out["fid"]), want, rtol=1e-4)
        # the members gather the FID samples once a batch; rank 3 gathers
        # nothing
        assert int(out["eval.all-gather"]) == (1 if r < 3 else 0)
