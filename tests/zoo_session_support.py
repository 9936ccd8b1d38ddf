"""Shared set-up of the zoo session tests (``tests/test_torch_zoo_session.py``,
``test_torch_zoo_sequential.py``): the reference's own zoo setting
(``tests/test_control_plane.py::test_cfl_session_transformer_rounds``:
granite reduced to 4 layers, d_model 64, ``seq_len=16``, 3 workers, 96
samples, ``heterogeneity="both"``), the reference's session on its
synthetic LM population, the port's session on the reference's data,
initial parameters and predictor, bridged, and the first local steps of
both batched engines."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core import submodel as ref_submodel
from repro.core.elastic import TransformerElasticFamily as RefFamily
from repro.fl import engine as ref_engine
from repro.fl import server as ref_server
from repro.fl import session as ref_session
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.elastic import TransformerElasticFamily
from repro_torch.core.submodel import TransformerSubSpec
from repro_torch.fl.client import ClientInfo
from repro_torch.fl.engine import pack_cohort_data
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession

import jax_compile_cache  # noqa: F401  (the shared compile cache)

TOL = 1e-5
ZOO_CFG = reduced(ARCHS["granite-3-8b"], n_layers=4, d_model=64)
REF_ZOO_CFG = ref_reduced(REF_ARCHS["granite-3-8b"], n_layers=4, d_model=64)
SEQ_LEN = 16
FL = dict(n_workers=3, local_epochs=1, batch_size=8, lr=0.05, seed=0)
POP = dict(n_workers=3, n_samples=96, heterogeneity="both")


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_spec(s):
    return ref_submodel.TransformerSubSpec(s.layers, s.ff_frac, s.expert_frac,
                                           s.ssm_head_frac, s.attn_head_frac)


def spec_of(genes):
    """The port's spec of a reference history entry's genes."""
    layers, ff, ex, sh, ah = genes
    return TransformerSubSpec(tuple(tuple(k) for k in layers), ff / 100,
                              ex / 100, sh / 100, ah / 100)


def reference_session(algorithm="cfl", fl=FL, rounds=2):
    """``rounds`` rounds of the reference's zoo session (dense path).
    Returns (session, initial params, the predictor's initial weights or
    None, round-0 params or None)."""
    fam = RefFamily(REF_ZOO_CFG, seq_len=SEQ_LEN)
    sess = ref_session.CFLSession.from_synthetic(
        fam, algorithm=algorithm, fl_cfg=ref_server.CFLConfig(**fl), **POP)
    init = numpy_tree(sess._init_params)
    if algorithm == "il":
        sess.run(rounds)
        return sess, init, None, None
    pred0 = numpy_tree(sess.server.predictor.params) \
        if algorithm == "cfl" else None
    sess.run(1)
    after0 = numpy_tree(sess.params)
    sess.run(rounds - 1)
    return sess, init, pred0, after0


def port_session(ref, init, pred0=None, *, algorithm="cfl", fl=FL,
                 dtype=np.float32, **fl_kw):
    """The port's session on the reference session's population, data,
    initial parameters and (cfl) predictor weights, on the CPU."""
    clients = [ClientInfo(**dataclasses.asdict(c)) for c in ref.clients]
    sess = CFLSession(
        TransformerElasticFamily(ZOO_CFG, seq_len=SEQ_LEN), clients,
        ref.client_data, ref.test_data, CFLConfig(**fl, **fl_kw),
        params=params_from_numpy(jax.tree.map(lambda a: a.astype(dtype),
                                              init), device="cpu"),
        algorithm=algorithm, device="cpu")
    if pred0 is not None:
        sess.server.predictor.load_numpy(pred0)
    return sess


def ratio(got, want, init, min_move=1e-3):
    """max |got − want| over max |want − init| (how far the run moved the
    parameters, at least ``min_move``)."""
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(want), jax.tree.leaves(init)))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(want)))
    assert moved > min_move
    return diff / moved


def _streams(ref, seeds, n_steps):
    """The clients' first ``n_steps`` batches of a round (the engines'
    index streams, later steps flagged invalid)."""
    idx, sv, stv, _ = ref_engine._pack_streams(
        [len(d["y"]) for d in ref.client_data], FL["batch_size"],
        epochs=FL["local_epochs"], seeds=seeds)
    return idx, sv, stv & (np.arange(stv.shape[1]) < n_steps)


def reference_steps(ref, init, specs, seeds, n_steps=1):
    """Every client's parameters after the first ``n_steps`` local steps
    of a round: the reference's batched engine's compiled program."""
    eng = ref.server.engine
    masks = eng._cohort_masks([ref_spec(s) for s in specs])
    x, y = eng._cohort_data(ref.client_data)
    _, trained = eng._train(eng.broadcast_params(init, len(specs)),
                            masks.param_mask, masks.fwd, x, y,
                            *_streams(ref, seeds, n_steps))
    return numpy_tree(trained)


def port_steps(engine, ref, init, specs, seeds, n_steps=1,
               dtype=np.float32):
    """The same steps on the port's batched ``engine`` in ``dtype``,
    through its ``local_step``."""
    K = len(specs)
    masks = engine.family.cohort_masks(specs, "cpu")
    x = torch.as_tensor(pack_cohort_data(ref.client_data)[0]).long()
    idx, sv, stv = _streams(ref, seeds, n_steps)
    rows = torch.arange(K)[:, None]
    params, opt = engine.local_state(engine.broadcast_params(
        params_from_numpy(jax.tree.map(lambda a: a.astype(dtype), init),
                          device="cpu"), K))
    for t in range(n_steps):
        i = torch.as_tensor(idx[:, t]).long()
        engine.local_step(params, opt, masks, x[rows, i],
                          torch.as_tensor(sv[:, t], dtype=torch.float64
                                          if dtype == np.float64
                                          else torch.float32),
                          None if stv[:, t].all()
                          else torch.as_tensor(stv[:, t]))
    return params_to_numpy(params)


def stacked(init, K):
    return [np.broadcast_to(a, (K,) + a.shape)
            for a in jax.tree.leaves(init)]
