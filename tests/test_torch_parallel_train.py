"""Port parity: ``train(mesh=)`` on 2 and 4 ranks (gloo, CPU) against
the port's loop in one process, and checkpoints across the two.

One launch per world size runs the loops on its ranks
(``torch_dist_workers.loops_suite``); the tests read its outputs.

* ``train(mesh=)`` loops (3 steps from N(0, 0.1^2) weights, dropout 0.1
  and flips drawn from the step's generator, ``grad_accum`` 1 and 2, with
  and without FSDP) against the same loop in one process: losses to 1e-4
  relative (JAX's ``tests/test_parallel.py:135``), the final params and
  EMA to 1e-5 absolute (fp32 rounding of the gradient sums, through three
  Adam steps of rate 1e-3); two runs on the same ranks bitwise equal, and
  every rank the same.
* Checkpoints: a save under the mesh resumes in one process, a save of
  one process resumes under the mesh, each equal to an uninterrupted run
  within the loops' tolerances (JAX's ``tests/test_parallel.py:243``
  holds the resumed layout).
"""

import numpy as np
import pytest

from torch_dist_workers import LOOPS, launch, run_loop
from torch_port_fixtures import two_torch_threads  # noqa: F401


def _flat(tensors):
    return np.concatenate([t.reshape(-1).numpy() for t in tensors.values()])


def _close_params(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"loops{world}")
    for name in ("dp", "fsdp"):  # one process's saves, resumed on the ranks
        run_loop(name, total=2, checkpoint_every=2,
                 checkpoint_dir=str(tmp / f"one_{name}"))
    return tmp, launch("loops", world, str(tmp))


@pytest.fixture(scope="module")
def one_process():
    """Each loop in one process: losses, final params and EMA (flat)."""
    out = {}
    for name in LOOPS:
        _, _, logged, p, e = run_loop(name)
        out[name] = (np.asarray([logged[k] for k in sorted(logged)]),
                     _flat(p), _flat(e))
    return out


@pytest.mark.parametrize("name", list(LOOPS))
def test_train_loop_matches_one_process(ranks, one_process, name):
    _, outs = ranks
    loss, p, e = one_process[name]
    out = outs[0]
    np.testing.assert_allclose(out[f"l.{name}.0.loss"], loss, rtol=1e-4)
    _close_params(out[f"l.{name}.0.p"], p)
    _close_params(out[f"l.{name}.0.e"], e)


def test_runs_repeat_bitwise_and_ranks_agree(ranks):
    _, outs = ranks
    for name in LOOPS:
        for key in ("loss", "p", "e"):
            np.testing.assert_array_equal(outs[0][f"l.{name}.1.{key}"],
                                          outs[0][f"l.{name}.0.{key}"])
    for other in outs[1:]:
        for k in outs[0]:
            np.testing.assert_array_equal(other[k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_checkpoint_from_mesh_resumes_in_one_process(ranks, one_process, name):
    """The ranks saved at step 2 (rank 0, whole); one process resumes to
    step 3 and lands where the uninterrupted run does."""
    tmp, _ = ranks
    _, _, logged, p, e = run_loop(name, total=3, checkpoint_every=100,
                                  checkpoint_dir=str(tmp / f"mesh_{name}"))
    loss, want_p, want_e = one_process[name]
    assert sorted(logged) == [3]
    np.testing.assert_allclose(logged[3], loss[2], rtol=1e-4)
    _close_params(_flat(p), want_p)
    _close_params(_flat(e), want_e)


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_checkpoint_from_one_process_resumes_on_the_mesh(ranks, name):
    """One process saved at step 2; the ranks resumed it to step 4, against
    one process's uninterrupted 4 steps."""
    _, outs = ranks
    _, _, logged, p, _ = run_loop(name, total=4)
    loss = np.asarray([logged[k] for k in sorted(logged)])
    np.testing.assert_allclose(outs[0][f"c.{name}.loss"], loss[2:], rtol=1e-4)
    _close_params(outs[0][f"c.{name}.p"], _flat(p))
