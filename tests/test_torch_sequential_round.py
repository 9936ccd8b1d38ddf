"""The port's sequential round against its batched dense round for the CNN
family (the sequential session against the reference:
``tests/test_torch_sequential.py``): the same parameters, specs and seeds
of the quickstart CNN (paper rule and coverage rule), in fp64 within
1e-5 of the round's movement, in fp32 within 1e-3 (the CNN's ReLUs flip
on rounding noise), accuracies within 1e-3; on the card (``cuda``) the
same against the batched dense engine.
"""

import jax
import numpy as np
import pytest
import torch

from cnn_session_support import (CFG, SPECS, TOL, params_and_clients,
                                 port_tree, ratio)
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.core.submodel import SubmodelSpec
from repro_torch.fl.engine import BatchedRoundEngine, SequentialFamilyTrainer

torch.set_num_threads(2)


@pytest.mark.parametrize("coverage_norm", [False, True])
def test_sequential_round_matches_batched_dense(coverage_norm):
    """fp64 holds the two engines to 1e-5 over the whole round; fp32 runs
    free (ReLU flips) and is held to 1e-3 of the movement, accuracies
    within 1e-3."""
    params, datasets = params_and_clients()
    specs = [SPECS["full"], SPECS["ragged"], SubmodelSpec((2, 1), (0.5, 0.5)),
             SubmodelSpec((1, 1), (1.0, 0.5))]
    kw = dict(batch_size=32, epochs=1, seeds=[11, 12, 13, 14],
              coverage_norm=coverage_norm)
    sizes = [len(d["y"]) for d in datasets]
    for dtype, tol, acc_tol in ((np.float64, TOL, 1e-3),
                                (np.float32, 1e-3, 1e-3)):
        train = [dict(d, x=d["x"].astype(dtype)) for d in datasets]
        tests = [{k: v[:40] for k, v in d.items()} for d in reversed(train)]
        p0 = port_tree(params, dtype)
        seq, accs_s, n_s = SequentialFamilyTrainer(
            CFG, lr=0.05, momentum=0.9).run_fl_round(p0, specs, train,
                                                     tests, sizes, **kw)
        bat, accs_b, n_b = BatchedRoundEngine(
            CFG, lr=0.05, momentum=0.9, backend=None,
            device="cpu").run_fl_round(p0, specs, train, tests, sizes, **kw)
        np.testing.assert_array_equal(n_s, n_b)
        assert ratio(params_to_numpy(seq), params_to_numpy(bat),
                     params_to_numpy(p0)) <= tol
        np.testing.assert_allclose(accs_s, accs_b, atol=acc_tol, rtol=0)


@pytest.mark.cuda
def test_cuda_sequential_round_matches_batched():
    """One round of the quickstart CNN's 4 clients on the card: the
    sequential trainer (the plain forward, cuDNN's convolutions) against
    the batched engine's dense path in fp64 within 1e-5 of the round's
    movement; in fp32 the sequential round twice, bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, datasets = params_and_clients()
    specs = [SPECS["full"], SPECS["ragged"], SubmodelSpec((2, 1), (0.5, 0.5)),
             SubmodelSpec((1, 1), (1.0, 0.5))]
    kw = dict(batch_size=32, epochs=1, seeds=[11, 12, 13, 14])
    sizes = [len(d["y"]) for d in datasets]
    tests = [{k: v[:40] for k, v in d.items()} for d in reversed(datasets)]

    def wide(ds):
        return [dict(d, x=d["x"].astype(np.float64)) for d in ds]

    def on_card(dtype):
        return params_from_numpy(jax.tree.map(lambda a: a.astype(dtype),
                                              params), device="cuda")
    seq = SequentialFamilyTrainer(CFG, lr=0.05, momentum=0.9)
    got, accs, _ = seq.run_fl_round(on_card(np.float64), specs,
                                    wide(datasets), wide(tests), sizes, **kw)
    want, want_accs, _ = BatchedRoundEngine(
        CFG, lr=0.05, momentum=0.9, backend=None,
        device="cuda").run_fl_round(on_card(np.float64), specs,
                                    wide(datasets), wide(tests), sizes, **kw)
    assert ratio(params_to_numpy(got), params_to_numpy(want), params) <= TOL
    np.testing.assert_allclose(accs, want_accs, atol=1e-3, rtol=0)
    one = [params_to_numpy(seq.run_fl_round(on_card(np.float32), specs,
                                            datasets, tests, sizes, **kw)[0])
           for _ in range(2)]
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(one[0]), jax.tree.leaves(one[1])))
