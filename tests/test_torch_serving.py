"""The port's serving slice against the JAX reference, and the port's
ground rules.

The slice: the port's ``EdgeServer`` on the CPU (the kernels' plain
versions behind the ``auto`` backend) against the reference's
``EdgeServer`` with its Pallas kernels in interpret mode, on the same
parameters, prompts and specs, 5 requests on 2 slots so tenants churn.
Greedy tokens must be identical and traced logits within 1e-4 — looser
than the per-op 1e-5 because the sums run in a different order through
2 layers and several decode steps.

The rules: no module of the port (nor ``chip_smoke.py``) imports JAX or the
JAX package; the serving package imports with both blocked; entry points
never drop silently to the CPU; prefixes reach the kernels as tensors.
"""
import ast
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core.elastic import family_for as ref_family_for
from repro.serving import EdgeServer as RefEdgeServer
from repro.serving import Request as RefRequest
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.elastic import family_for
from repro_torch.kernels import dispatch
from repro_torch.serving import ContinuousBatcher, EdgeServer, Request

torch.set_num_threads(2)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SLICE_TOL = 1e-4


def _slice_setup():
    ref_fam = ref_family_for(ref_reduced(REF_ARCHS["granite-3-8b"],
                                         n_layers=2, d_model=64))
    fam = family_for(reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=64))
    ref_params = ref_fam.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    rng = random.Random(0)
    specs = [fam.random_spec(rng), fam.random_spec(rng), fam.full_spec()]
    prng = np.random.default_rng(1)
    # prompts shorter and longer than the window; staggered budgets churn
    prompts = [prng.integers(0, 512, (n,)) for n in (8, 5, 11, 8, 3)]
    budgets = [5, 3, 4, 2, 5]
    return ref_fam, ref_params, fam, params, specs, prompts, budgets


@pytest.mark.parametrize("backend,ref_backend", [("auto", "interpret"),
                                                 (None, None)])
def test_edge_server_matches_reference(backend, ref_backend):
    ref_fam, ref_params, fam, params, specs, prompts, budgets = \
        _slice_setup()
    P, G = 8, 5
    ref_server = RefEdgeServer(ref_fam, ref_params, slots=2, prompt_len=P,
                               max_new_tokens=G, backend=ref_backend,
                               trace_logits=True)
    # the reference's specs are its own dataclass; genes are shared
    from repro.core.submodel import TransformerSubSpec as RefSpec
    ref_specs = [RefSpec(s.layers, s.ff_frac, s.expert_frac,
                         s.ssm_head_frac, s.attn_head_frac) for s in specs]
    ref_out = ref_server.run([
        RefRequest(uid=i, spec=ref_specs[i % 3], prompt=prompts[i],
                   max_new_tokens=budgets[i]) for i in range(5)])
    server = EdgeServer(fam, params, slots=2, prompt_len=P,
                        max_new_tokens=G, backend=backend,
                        trace_logits=True, device="cpu")
    out = server.run([Request(uid=i, spec=specs[i % 3], prompt=prompts[i],
                              max_new_tokens=budgets[i]) for i in range(5)])
    assert [c.uid for c in out] == [c.uid for c in ref_out] == list(range(5))
    for c, r in zip(out, ref_out):
        assert c.tokens == r.tokens, c.uid
        assert len(c.logits) == len(r.logits) == budgets[c.uid]
        worst = max(float(np.max(np.abs(a - b)))
                    for a, b in zip(c.logits, r.logits))
        assert worst <= SLICE_TOL, f"uid={c.uid}: {worst:.2e}"


def test_prefixes_reach_the_kernels_as_tensors(monkeypatch):
    """Spec churn changes tensor values only: every elastic_dense call on
    the serving path gets (G,) int32 prefix tensors, never Python ints."""
    _, _, fam, params, specs, prompts, _ = _slice_setup()
    seen = []
    real = dispatch.elastic_dense

    def spy(x, w, bias=None, **kw):
        seen.append({k: v for k, v in kw.items() if k.endswith("_active")})
        return real(x, w, bias, **kw)
    monkeypatch.setattr(dispatch, "elastic_dense", spy)
    server = EdgeServer(fam, params, slots=2, prompt_len=6,
                        max_new_tokens=3, backend="auto", device="cpu")
    server.run([Request(uid=i, spec=specs[i % 3], prompt=prompts[i],
                        max_new_tokens=3) for i in range(3)])
    prefixes = [v for call in seen for v in call.values() if v is not None]
    assert prefixes and len(seen) % 3 == 0
    for v in prefixes:
        assert isinstance(v, torch.Tensor) and v.dtype == torch.int32
    # decode steps carry one prefix per slot
    assert any(v.shape == (2,) for v in prefixes)


def test_serve_cli_runs_on_cpu():
    from repro_torch.launch.serve import serve
    kw = dict(batch=3, prompt_len=6, gen=3, n_layers=2, d_model=64,
              elastic=True, device="cpu")
    out, stats = serve("granite-3-8b", backend="auto", **kw)
    dense, _ = serve("granite-3-8b", backend=None, **kw)
    assert [len(c.tokens) for c in out] == [3, 3, 3]
    assert [c.tokens for c in out] == [c.tokens for c in dense]
    assert stats["tokens_per_s"] > 0


def _port_files():
    base = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the test-support module chip_smoke.py imports
    yield os.path.join(ROOT, "tests", "relu_replay.py")


def test_port_imports_neither_jax_nor_reference():
    files = list(_port_files())
    assert len(files) > 15
    names = {os.path.relpath(p, ROOT) for p in files}
    for new in ("checkpoint/fleet.py", "serving/export.py",
                "serving/distill.py", "sharding/__init__.py",
                "sharding/cohort.py", "sharding/mesh.py",
                "sharding/specs.py", "launch/mesh.py"):
        assert os.path.join("src", "repro_torch", new) in names
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{os.path.relpath(path, ROOT)} imports {name}"


def test_port_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.serving, repro_torch.launch.serve\n"
            "import repro_torch.fl.engine, repro_torch.data.synth\n"
            "import repro_torch.checkpoint.io, repro_torch.checkpoint.bridge\n"
            "import repro_torch.fl.session, repro_torch.fl.rounds\n"
            "import repro_torch.kernels.elastic_conv, repro_torch.models.cnn\n"
            "import repro_torch.fl, repro_torch.fl.baselines\n"
            "import repro_torch.checkpoint, repro_torch.checkpoint.fleet\n"
            "import repro_torch.serving.export, repro_torch.serving.distill\n"
            "import repro_torch.fl.runtime, repro_torch.fl.faults\n"
            "import repro_torch.sharding, repro_torch.sharding.cohort\n"
            "import repro_torch.sharding.mesh, repro_torch.sharding.specs\n"
            "import repro_torch.launch.mesh, repro_torch.launch.steps\n"
            "import chip_smoke, relu_replay\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT, "tests")])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_entry_points_never_drop_silently_to_cpu(monkeypatch):
    _, _, fam, params, _, _, _ = _slice_setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EdgeServer(fam, params, slots=2)
    from repro_torch.launch.serve import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("granite-3-8b", batch=1, prompt_len=4, gen=1, n_layers=2,
              d_model=64)
    # the parameter constructors and the training engine default to the
    # card too
    from repro_torch.fl.engine import BatchedRoundEngine
    from repro_torch.models import transformer as T
    with pytest.raises(RuntimeError, match="CUDA"):
        fam.init_params(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(fam.cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedRoundEngine(fam, lr=0.1, momentum=0.9)
    with pytest.raises(RuntimeError, match="CUDA"):
        fam.cohort_masks([fam.full_spec()])


def test_constructors_never_drop_silently_to_cpu(monkeypatch):
    """The decode caches, one attention cache and the weight bridge default
    to the card too: without CUDA and without a device they raise."""
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    _, _, fam, _, _, _, _ = _slice_setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_decode_caches(fam.cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.gqa_cache_init(2, 8, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros((2, 3), np.float32)})
    # the CPU when asked for
    assert T.init_decode_caches(fam.cfg, 2, 8, device="cpu").segments[
        0].k.device.type == "cpu"
    assert params_from_numpy({"w": np.zeros(2, np.float32)},
                             device="cpu")["w"].device.type == "cpu"


def test_batcher_slot_lifecycle():
    b = ContinuousBatcher(2)
    for i in range(3):
        b.submit(Request(uid=i, spec=None, prompt=np.zeros((2,), np.int32),
                         max_new_tokens=1 + i))
    assert b.admit() == [0, 1]
    assert b.admit() == []
    assert b.record(0, 7) is not None
    assert b.admit() == [0]
    assert b.request_at(0).uid == 2
    assert b.record(1, 7) is None
    c = b.record(1, 8)
    assert c is not None and c.tokens == [7, 8]
