"""The rest of the port's serving (``serving.export``, ``serving.distill``,
``CFLSession.serving``, ``launch.serve.check_prefill_parity``) against the
JAX reference, on a granite-3-8b parent reduced to 2 layers and d_model 64
(and a mamba2-2.7b one for the prefill), on the CPU:

* ``spec_payload`` gives the reference's dict for a CNN and a transformer
  spec;
* the npz manifest is shared: a submodel the port exports restores in the
  reference's ``restore_checkpoint`` bit for bit, and the reverse;
  ``load_submodel`` (its template on the ``meta`` device) equals
  ``family.extract`` bit for bit, its metadata has the reference's keys
  and its latency rows agree within 1e-12;
* ``distill_to_spec`` — 3 steps on the reference's parent, bridged — has
  the reference's KL history and student parameters within 1e-5, on the
  dense teacher and on the kernel table's (the kernels' plain versions
  here); the distilled student beats a random-init one;
* the fused prefill equals the stepwise decode within 1e-5;
* ``session.serving()`` decodes the greedy tokens of an ``EdgeServer``
  built on ``session.params``, and a family without a decode path is
  rejected.
"""
import os
import random

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import restore_checkpoint as ref_restore
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import submodel as ref_submodel
from repro.core.elastic import family_for as ref_family_for
from repro.serving import distill_to_spec as ref_distill
from repro.serving import export_submodel as ref_export
from repro.serving import spec_payload as ref_spec_payload
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.checkpoint.io import _flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.elastic import TransformerElasticFamily, family_for
from repro_torch.core.submodel import SubmodelSpec
from repro_torch.data.synth import make_lm_dataset
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.launch.serve import check_prefill_parity
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serving import (EdgeServer, Request, distill_to_spec,
                                 export_submodel, load_submodel,
                                 payload_spec, spec_payload)

torch.set_num_threads(2)
TOL = 1e-5
QUICK = dict(name="quickstart", in_channels=1, image_size=28,
             stem_channels=8, stages=((16, 2), (32, 2)), groupnorm_groups=4,
             elastic_widths=(0.5, 1.0))


def dense_pair():
    """The reduced granite parent in both packages, the reference's
    parameters (key 0) and the port's bridged copy."""
    ref_fam = ref_family_for(ref_reduced(REF_ARCHS["granite-3-8b"],
                                         n_layers=2, d_model=64))
    fam = family_for(reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=64))
    ref_params = ref_fam.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    return ref_fam, ref_params, fam, params


def assert_same_tree(got, want, atol=None):
    """Leaf by leaf, by path (either package's tree): equal to the bit and
    of one dtype, or within ``atol``."""
    got, want = _flatten(got), _flatten(want)
    assert set(got) == set(want)
    for k, b in want.items():
        if atol is None:
            assert got[k].dtype == b.dtype and np.array_equal(got[k], b), k
        else:
            np.testing.assert_allclose(got[k], b, atol=atol, rtol=0)


def ref_spec(s):
    return ref_submodel.TransformerSubSpec(s.layers, s.ff_frac, s.expert_frac,
                                           s.ssm_head_frac, s.attn_head_frac)


def test_spec_payload_matches_reference():
    fam = family_for(reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=64))
    spec = fam.random_spec(random.Random(3))
    got = spec_payload(spec)
    assert got == ref_spec_payload(ref_spec(spec))
    assert payload_spec(got) == spec
    cnn = SubmodelSpec((1, 2), (0.5, 1.0))
    got = spec_payload(cnn)
    assert got == ref_spec_payload(ref_submodel.SubmodelSpec((1, 2),
                                                             (0.5, 1.0)))
    assert payload_spec(got) == cnn
    with pytest.raises(TypeError):
        spec_payload((1, 2))


def test_export_manifest_is_shared_with_reference(tmp_path):
    ref_fam, ref_params, fam, params = dense_pair()
    spec = fam.random_spec(random.Random(2))
    want, ctx = fam.extract(params, spec)
    # the port's export restores in the reference, bit for bit
    path = os.fspath(tmp_path / "port.npz")
    meta = export_submodel(fam, params, spec, path)
    ref_want, ref_ctx = ref_fam.extract(ref_params, ref_spec(spec))
    assert_same_tree(ref_restore(path, ref_want), want)
    # ... and the reference's in the port, through load_submodel
    ref_path = os.fspath(tmp_path / "ref.npz")
    ref_meta = ref_export(ref_fam, ref_params, ref_spec(spec), ref_path)
    sub, sub_ctx, meta2 = load_submodel(fam, ref_path, device="cpu")
    assert sub_ctx == ctx and payload_spec(meta2["spec"]) == spec
    assert_same_tree(sub, want)
    # the port's own round trip: extract's very bits, the reference's
    # metadata keys, its prices within 1e-12
    sub, _, meta3 = load_submodel(fam, path, device="cpu")
    assert all(a.device.type == "cpu" for a in tree_leaves(sub))
    assert_same_tree(sub, want)
    assert meta3 == meta and set(meta) == set(ref_meta)
    assert set(meta["latency"]) == set(ref_meta["latency"])
    for dev, row in meta["latency"].items():
        for k, v in row.items():
            assert abs(v - ref_meta["latency"][dev][k]) <= 1e-12 * abs(v)
    for k in ("family", "arch", "spec"):
        assert meta[k] == ref_meta[k]
    for k in ("flops", "flops_fraction", "param_bytes"):
        assert abs(meta[k] - ref_meta[k]) <= 1e-12 * abs(ref_meta[k])


def test_export_load_cnn_roundtrip(tmp_path):
    fam = family_for(CNNConfig(**QUICK))
    params = fam.init_params(seed=1, device="cpu")
    spec = SubmodelSpec((1, 2), (0.5, 1.0))
    path = os.fspath(tmp_path / "cnn.npz")
    export_submodel(fam, params, spec, path)
    sub, ctx, _ = load_submodel(fam, path, device="cpu")
    want, want_ctx = fam.extract(params, spec)
    assert ctx == want_ctx
    assert_same_tree(sub, want)
    ref_sub = ref_restore(path, jax.eval_shape(
        lambda k: ref_family_for(RefCNNConfig(**QUICK)).extract(
            ref_family_for(RefCNNConfig(**QUICK)).init_params(k),
            ref_submodel.SubmodelSpec((1, 2), (0.5, 1.0)))[0],
        jax.random.PRNGKey(0)))
    assert_same_tree(ref_sub, want)


@pytest.fixture(scope="module")
def distilled():
    """3 distillation steps of the reference on its parent (the dense
    teacher), with the data and spec both packages use."""
    ref_fam, ref_params, fam, params = dense_pair()
    spec = fam.random_spec(random.Random(4))
    data = make_lm_dataset(24, 16, fam.cfg.vocab_size, seed=0)
    sub, _, hist = ref_distill(ref_fam, ref_params, ref_spec(spec),
                               {"x": data["x"]}, steps=3, batch_size=8,
                               seed=0)
    return fam, params, spec, data, jax.tree.map(np.asarray, sub), hist


@pytest.mark.parametrize("backend", [None, "auto"])
def test_distill_matches_reference(distilled, backend):
    fam, params, spec, data, ref_sub, ref_hist = distilled
    kernels = kernel_dispatch(backend).table(fam.name)
    sub, ctx, hist = distill_to_spec(fam, params, spec, {"x": data["x"]},
                                     steps=3, batch_size=8, seed=0,
                                     kernels=kernels)
    assert ctx == fam.sub_ctx(spec)
    np.testing.assert_allclose(hist, ref_hist, rtol=TOL, atol=0)
    assert_same_tree(sub, ref_sub, atol=TOL)
    # the parent is the teacher, never trained
    assert_same_tree(params, dense_pair()[3])


def test_distilled_student_beats_random_init(distilled):
    """A teacher with confident logits (the tied embedding scaled up): the
    student warm-started from its extract stays closer to it than a
    random-init one gets, and the random one learns."""
    fam, params, spec, data, _, _ = distilled
    params = dict(params, embed={"table": params["embed"]["table"] * 30})
    kw = dict(steps=6, batch_size=8, seed=0, lr=0.1)
    _, _, warm = distill_to_spec(fam, params, spec, {"x": data["x"]}, **kw)
    _, _, cold = distill_to_spec(fam, params, spec, {"x": data["x"]},
                                 student_init="random", **kw)
    assert max(warm) < min(cold)
    assert cold[-1] < cold[0]                # the random student learns
    with pytest.raises(ValueError, match="student_init"):
        distill_to_spec(fam, params, spec, {"x": data["x"]},
                        student_init="zeros")


@pytest.mark.parametrize("arch,prompt", [("granite-3-8b", 10),
                                         ("mamba2-2.7b", 16)])
def test_fused_prefill_matches_stepwise(arch, prompt):
    fam = family_for(reduced(ARCHS[arch], n_layers=2, d_model=64))
    params = fam.init_params(seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, fam.cfg.vocab_size, (2, prompt)))
    assert check_prefill_parity(params, fam.cfg, toks,
                                max_len=prompt + 4) <= 1e-5


def test_session_serving_hands_off_the_trained_parent():
    fam = TransformerElasticFamily(
        reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=64), seq_len=16)
    sess = CFLSession.from_synthetic(
        fam, n_workers=2, n_samples=64, device="cpu",
        fl_cfg=CFLConfig(n_workers=2, local_epochs=1, batch_size=8,
                         lr=0.05, seed=0))
    sess.run(1)
    rng = random.Random(5)
    specs = [fam.random_spec(rng), fam.full_spec(), fam.random_spec(rng)]
    prompts = np.random.default_rng(2).integers(0, fam.cfg.vocab_size,
                                                (3, 4))
    reqs = [Request(uid=i, spec=specs[i], prompt=prompts[i],
                    max_new_tokens=3) for i in range(3)]
    kw = dict(slots=2, prompt_len=4, max_new_tokens=3, trace_logits=True)
    got = sess.serving(**kw).run(reqs)
    want = EdgeServer(fam, sess.params, device="cpu", **kw).run(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert all(len(c.tokens) == 3 for c in got)
    for c, w in zip(got, want):
        for a, b in zip(c.logits, w.logits):
            np.testing.assert_array_equal(a, b)
    cnn = CFLSession.from_synthetic(
        CNNConfig(**QUICK), kind="synthmnist", n_workers=2, n_samples=100,
        device="cpu", fl_cfg=CFLConfig(n_workers=2))
    with pytest.raises(ValueError, match="decode"):
        cnn.serving(slots=1)
