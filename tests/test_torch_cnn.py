"""The port's CNN slice against the JAX reference.

At small sizes on numpy-seeded inputs (or inputs bridged from the
reference, whose parameters and images are ``jax.random`` draws):

* the host modules: ``data/quality.py``, ``data/loader.py``,
  ``channels_of``, ``mask_cnn`` / ``coverage_cnn`` and the spec masks —
  exactly equal; ``make_dataset``'s torch-seeded stand-in has the
  reference's shapes, dtypes, value range and class structure;
* ``elastic_conv2d`` (on the CPU: K1's plain version) against the
  reference's ``elastic_conv2d`` in Pallas interpret mode, forward and the
  gradients of x, w and b, with per-client prefixes 0 / ragged / full and
  None, strides 1 and 2, 8×8 and 7×7 inputs: ≤1e-5 of each output's max;
  K1's per-group bias against a per-group loop of the shared bias,
  bit-equal;
* the forward, the masked forward and a round:
  ``tests/test_torch_cnn_model.py``.

On the card (``-m cuda``) K1 with a per-group bias is held bit-equal to K1
without one plus the bias.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import elastic as ref_elastic
from repro.core import submodel as ref_submodel
from repro.data import loader as ref_loader
from repro.data import quality as ref_quality
from repro.data import synth as ref_synth
from repro.kernels.elastic_conv import elastic_conv2d as ref_conv2d
from repro.models import cnn as ref_cnn
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.paper_cnn import MNIST_CNN, PAPER_CNN, CNNConfig
from repro_torch.core import elastic, submodel
from repro_torch.core.submodel import SubmodelSpec
from repro_torch.data import loader, quality, synth
from repro_torch.kernels.elastic_conv import (elastic_conv2d,
                                              elastic_conv2d_plain)
from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                elastic_dense_plain)

torch.set_num_threads(2)
TOL = 1e-5
# the reference's paper_cnn module is re-exported under the same names
ref_paper_cnn = importlib.import_module("repro.configs.paper_cnn")

# the quickstart's CNN (examples/quickstart.py) at 16×16 inputs
SMALL = dict(name="small", in_channels=1, image_size=16, stem_channels=8,
             stages=((16, 2), (32, 2)), groupnorm_groups=4,
             elastic_widths=(0.5, 1.0))
CFG, REF_CFG = CNNConfig(**SMALL), RefCNNConfig(**SMALL)
# the full parent, a narrow one, a shallow one, both cut
SPECS = [SubmodelSpec((2, 2), (1.0, 1.0)), SubmodelSpec((2, 2), (0.5, 0.5)),
         SubmodelSpec((1, 2), (1.0, 0.5)), SubmodelSpec((1, 1), (0.5, 1.0))]


def _ref_specs(specs):
    return [ref_submodel.SubmodelSpec(s.depth, s.width) for s in specs]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=tol, rtol=0)


def _equal(got, want):
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# host modules
# ---------------------------------------------------------------------------
def test_configs_equal_reference():
    for port, ref in ((PAPER_CNN, ref_paper_cnn.PAPER_CNN),
                      (MNIST_CNN, ref_paper_cnn.MNIST_CNN)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_blocks == ref.n_blocks


def test_quality_bit_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.random((5, 12, 10, 3)).astype(np.float32)
    for sigma in (0.6, 1.2, 2.0):
        np.testing.assert_array_equal(quality.gaussian_blur(x, sigma),
                                      ref_quality.gaussian_blur(x, sigma))
    np.testing.assert_array_equal(quality.sharpen(x),
                                  ref_quality.sharpen(x))
    for level in range(quality.N_LEVELS):
        np.testing.assert_array_equal(quality.apply_quality(x, level),
                                      ref_quality.apply_quality(x, level))
    data = {"x": x, "y": rng.integers(0, 10, 5).astype(np.int32)}
    _equal(quality.mixed_quality_dataset(data, seed=3),
           ref_quality.mixed_quality_dataset(data, seed=3))
    with pytest.raises(ValueError):
        quality.apply_quality(x, 5)


def test_make_dataset_stand_in():
    for kind in ("synthcifar", "synthmnist"):
        got = synth.make_dataset(kind, 200, seed=1)
        want = ref_synth.make_dataset(kind, 8, seed=1)
        assert got["x"].shape[1:] == want["x"].shape[1:]
        assert got["x"].dtype == want["x"].dtype
        assert got["y"].dtype == want["y"].dtype
        assert got["x"].min() >= 0.0 and got["x"].max() <= 1.0
        assert set(np.unique(got["y"])) <= set(range(10))
        again = synth.make_dataset(kind, 200, seed=1)
        _equal(again, got)
        # class structure: nearest class mean, fitted on half, classifies
        # the other half
        x = got["x"].reshape(200, -1)
        y = got["y"]
        means = np.stack([x[:100][y[:100] == c].mean(0) for c in range(10)])
        pred = np.argmin(((x[100:, None] - means[None]) ** 2).sum(-1), -1)
        assert (pred == y[100:]).mean() > 0.8
    with pytest.raises(ValueError):
        synth.make_dataset("cifar", 4)


def test_loader_iterators_equal_reference():
    rng = np.random.default_rng(2)
    data = {"x": rng.random((11, 3)).astype(np.float32),
            "y": np.arange(11, dtype=np.int32)}
    for kw in (dict(seed=4, epochs=2), dict(seed=1, epochs=1,
                                            drop_remainder=False)):
        got = list(loader.batches(data, 4, **kw))
        want = list(ref_loader.batches(data, 4, **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    for a, b in zip(loader.eval_batches(data, 4),
                    ref_loader.eval_batches(data, 4)):
        _equal(a, b)


def test_channels_masks_and_coverage_equal_reference():
    ref_fam = ref_elastic.family_for(REF_CFG)
    fam = elastic.family_for(CFG)
    assert isinstance(fam, elastic.CNNElasticFamily)
    assert elastic.family_for(fam) is fam
    template = _np(ref_cnn.init_params(jax.random.PRNGKey(0), REF_CFG))
    for cfg, ref_cfg in ((CFG, REF_CFG), (PAPER_CNN,
                                          ref_paper_cnn.PAPER_CNN)):
        for si in range(len(cfg.stages)):
            for frac in (0.25, 0.5, 0.75, 1.0, 0.3):
                assert submodel.channels_of(cfg, si, frac) == \
                    ref_submodel.channels_of(ref_cfg, si, frac)
    for spec, ref_spec in zip(SPECS, _ref_specs(SPECS)):
        assert spec.genes() == ref_spec.genes()
        _equal(submodel.mask_cnn(CFG, spec),
               ref_submodel.mask_cnn(REF_CFG, ref_spec))
        _equal(params_to_numpy(submodel.coverage_cnn(
            params_from_numpy(template, device="cpu"), CFG, spec)),
            _np(ref_submodel.coverage_cnn(template, REF_CFG, ref_spec)))
        got, want = fam.spec_masks(spec), ref_fam.spec_masks(ref_spec)
        _equal(got.param_mask, want.param_mask)
        _equal(got.fwd, want.fwd)
        assert submodel.sub_cnn_config(CFG, spec).stages == \
            ref_submodel.sub_cnn_config(REF_CFG, ref_spec).stages
    assert submodel.full_spec(CFG) == SubmodelSpec((2, 2), (1.0, 1.0))
    assert submodel.minimal_spec(CFG).genes() == \
        ref_submodel.minimal_spec(REF_CFG).genes()


# ---------------------------------------------------------------------------
# elastic_conv2d (K1) against the reference's interpret-mode lowering
# ---------------------------------------------------------------------------
# per client: input-channel prefix 0 / ragged / full / ragged, output
# prefix full / ragged / 0 / ragged (every client a different submodel)
MIXED = ([0, 5, 16, 9], [32, 7, 0, 24])


@pytest.mark.parametrize("prefixes", ["mixed", None])
@pytest.mark.parametrize("size,stride", [(8, 1), (8, 2), (7, 2)])
def test_elastic_conv2d_matches_reference(prefixes, size, stride):
    G, B, cin, cout = 4, 2, 16, 32
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((G, B, size, size, cin)).astype(np.float32)
    w = rng.standard_normal((G, 3, 3, cin, cout)).astype(np.float32)
    b = rng.standard_normal((G, cout)).astype(np.float32)
    dy = rng.standard_normal((G, B, -(-size // stride), -(-size // stride),
                              cout)).astype(np.float32)
    ca, co = ((np.asarray(p, np.int32) for p in MIXED) if prefixes
              else (None, None))

    def ref_fn(x, w, b):
        if ca is None:
            return jax.vmap(lambda x, w, b: ref_conv2d(
                x, w, b, stride=stride, interpret=True))(x, w, b)
        return jax.vmap(lambda x, w, b, c, o: ref_conv2d(
            x, w, b, stride=stride, cin_active=c, cout_active=o,
            interpret=True))(x, w, b, ca, co)

    want, vjp = jax.vjp(ref_fn, x, w, b)
    want_grads = vjp(jnp.asarray(dy))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    cat = None if ca is None else torch.as_tensor(ca)
    cot = None if co is None else torch.as_tensor(co)
    got = elastic_conv2d(xt, wt, bt, stride=stride, cin_active=cat,
                         cout_active=cot)
    grads = torch.autograd.grad(got, (xt, wt, bt), torch.as_tensor(dy))
    for g, r in zip((got,) + grads, (want,) + tuple(want_grads)):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.detach().numpy(), r,
                                   atol=TOL * np.abs(r).max(), rtol=0)
    # the direct convolution under the same masks
    plain = elastic_conv2d_plain(xt, wt, bt, stride=stride, cin_active=cat,
                                 cout_active=cot)
    np.testing.assert_allclose(plain.detach().numpy(), np.asarray(want),
                               atol=TOL * np.abs(want).max(), rtol=0)


def test_per_group_bias_bit_equal_loop_of_shared_bias():
    G, M, K, N = 3, 10, 12, 9
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((G, M, K)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((G, K, N)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((G, N)), dtype=torch.float32)
    ka = torch.tensor([0, 7, 12], dtype=torch.int32)
    na = torch.tensor([9, 4, 0], dtype=torch.int32)
    for act in (None, "relu", "gelu"):
        got = elastic_dense_plain(x, w, b, k_active=ka, n_active=na,
                                  act=act)
        for g in range(G):
            want = elastic_dense_plain(x[g:g + 1], w[g:g + 1], b[g],
                                       k_active=ka[g:g + 1],
                                       n_active=na[g:g + 1], act=act)
            assert torch.equal(got[g:g + 1], want)
    # the gradient of a per-group bias is per group; a broadcast view of
    # one row gets the sum of the groups' gradients
    bt = b.clone().requires_grad_(True)
    dy = torch.tensor(rng.standard_normal((G, M, N)), dtype=torch.float32)
    db, = torch.autograd.grad(elastic_dense(
        x, w, bt, k_active=ka, n_active=na), bt, dy)
    live = (torch.arange(N) < na[:, None]).float()
    assert torch.equal(db, (dy * live[:, None, :]).sum(1))
    b1 = b[0].clone().requires_grad_(True)
    db1, = torch.autograd.grad(elastic_dense(
        x, w, b1.expand(G, N), k_active=ka, n_active=na), b1, dy)
    torch.testing.assert_close(db1, db.sum(0), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="bias must be"):
        elastic_dense(x, w, torch.zeros(G, N + 1))


@pytest.mark.cuda
def test_cuda_per_group_bias_is_kernel_plus_bias():
    """K1 with a per-group bias equals K1 without one plus the bias, bit
    for bit (the kernel adds the bias to the same fp32 sum), in every
    variant and with the split of the contraction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    for G, M, K, N in ((8, 512, 288, 32), (2, 40, 1152, 128),
                       (3, 70, 13, 9)):
        x = torch.randn((G, M, K), generator=gen).to(dev)
        w = torch.randn((G, K, N), generator=gen).to(dev)
        b = torch.randn((G, N), generator=gen).to(dev)
        na = torch.randint(0, N + 1, (G,), generator=gen,
                           dtype=torch.int32).to(dev)
        ka = torch.randint(0, K + 1, (G,), generator=gen,
                           dtype=torch.int32).to(dev)
        got = elastic_dense(x, w, b, k_active=ka, n_active=na)
        raw = elastic_dense(x, w, None, k_active=ka, n_active=na)
        live = torch.arange(N, device=dev) < na[:, None, None]
        want = torch.where(live, raw + b[:, None, :], torch.zeros((),
                                                                 device=dev))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
