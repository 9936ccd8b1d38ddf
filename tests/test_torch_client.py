"""The port's one-client training (``fl.client``: ``local_train``,
``evaluate``, ``sgd_step``; ``SequentialFamilyTrainer.client_update`` with
the family's ``pad_delta``) against the JAX reference, on the reference's
initial quickstart parameters and synthetic MNIST clients, bridged.

* one local step in fp32: the update within 1e-5;
* two steps (momentum carried) in fp64, on the exact ReLU decisions:
  within 1e-5 of their movement;
* batches of 32 over two epochs: the same step counts and submodels; their
  fp32 values are not held, because on the first batch the port's fp32
  forward takes a ReLU decision the other way from its fp64 forward (a
  pre-activation within rounding noise of 0), which is asserted;
* ``evaluate`` at full and cut depth: the same accuracy; ``pad_delta`` of
  one update: exactly the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from cnn_session_support import (CFG, REF_CFG, SPECS, TOL, assert_close,
                                 numpy_tree, params_and_clients, port_tree,
                                 ratio)
from relu_replay import ReluDecisions
from repro.core import elastic as ref_elastic
from repro.core import submodel as ref_submodel
from repro.fl import client as ref_client
from repro.fl import engine as ref_engine
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.data.loader import index_batches
from repro_torch.fl import client
from repro_torch.fl.engine import SequentialFamilyTrainer
from repro_torch.models import cnn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    return params_and_clients()


def test_local_train_and_evaluate_match_reference(setup):
    params, datasets = setup
    data = datasets[0]
    kw = dict(lr=0.05, momentum=0.9, seed=5)
    zero = jax.tree.map(np.zeros_like, params)
    # one local step in fp32: held to 1e-5
    one = dict(kw, epochs=1, batch_size=len(data["y"]))
    delta, n = client.local_train(port_tree(params), CFG, data, **one)
    ref_delta, ref_n = ref_client.local_train(params, REF_CFG, data, **one)
    assert n == ref_n == 1
    assert_close(delta, ref_delta, TOL)
    # two steps (momentum carried) in fp64, on the exact ReLU decisions:
    # within 1e-5 of their movement
    two = dict(kw, epochs=2, batch_size=len(data["y"]))
    wide = dict(data, x=data["x"].astype(np.float64))
    delta, n = client.local_train(port_tree(params, np.float64), CFG, wide,
                                  **two)
    ref_delta, ref_n = ref_client.local_train(params, REF_CFG, data, **two)
    assert n == ref_n == 2
    assert ratio(params_to_numpy(delta), numpy_tree(ref_delta), zero,
                 1e-3) <= TOL
    # batches of 32: the same step count; the fp32 values are not held,
    # since on the first batch the port's fp32 forward takes a ReLU
    # decision the other way from its fp64 forward
    four = dict(kw, epochs=2, batch_size=32)
    _, n = client.local_train(port_tree(params), CFG, data, **four)
    assert n == ref_client.local_train(params, REF_CFG, data, **four)[1] == 4
    idx = next(index_batches(len(data["y"]), 32, seed=5))
    relus = ReluDecisions()
    with relus("record"):
        cnn.forward(port_tree(params, np.float64), CFG,
                    torch.as_tensor(data["x"][idx], dtype=torch.float64))
    with relus("count"):
        cnn.forward(port_tree(params), CFG, torch.as_tensor(data["x"][idx]))
    assert relus.flips() >= 1
    for depth in (None, (1, 1)):
        assert client.evaluate(port_tree(params), CFG, datasets[1],
                               depth=depth) == \
            ref_client.evaluate(params, REF_CFG, datasets[1], depth=depth)


@pytest.mark.parametrize("which", sorted(SPECS))
def test_client_update_matches_reference(setup, which):
    """One fp32 step within 1e-5; two fp64 steps within 1e-5 of their
    movement; batches of 32 the same step count and submodel."""
    params, datasets = setup
    spec = SPECS[which]
    ref_spec = ref_submodel.SubmodelSpec(spec.depth, spec.width)
    seq = SequentialFamilyTrainer(CFG, lr=0.05, momentum=0.9)
    ref_seq = ref_engine.SequentialFamilyTrainer(REF_CFG, lr=0.05,
                                                 momentum=0.9)
    data = datasets[2]
    n_all = len(data["y"])
    for batch_size, epochs, dtype in ((n_all, 1, np.float32),
                                      (n_all, 2, np.float64),
                                      (32, 2, np.float32)):
        kw = dict(batch_size=batch_size, epochs=epochs, seed=9)
        train = dict(data, x=data["x"].astype(dtype))
        delta, trained, ctx, n = seq.client_update(port_tree(params, dtype),
                                                   spec, train, **kw)
        rdelta, rtrained, rctx, rn = ref_seq.client_update(
            params, ref_spec, data, **kw)
        assert n == rn and ctx.stages == rctx.stages
        if batch_size == 32:
            continue
        if dtype == np.float32:
            assert_close(delta, rdelta, TOL)
            assert_close(trained, rtrained, TOL)
        else:
            zero = jax.tree.map(np.zeros_like, numpy_tree(rdelta))
            assert ratio(params_to_numpy(delta), numpy_tree(rdelta), zero,
                         1e-3) <= TOL
    # the alignment of one and the same update
    padded = seq.family.pad_delta(port_tree(numpy_tree(rdelta)),
                                  port_tree(params), spec)
    want = ref_elastic.family_for(REF_CFG).pad_delta(rdelta, params,
                                                     ref_spec)
    assert_close(padded, want, 0.0)
