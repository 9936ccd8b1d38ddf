"""Extract-and-serve: spec -> dense submodel checkpoint -> load — the port
of the reference's ``serving/export.py``.

A client whose spec the control plane searched gets a *dense* submodel
(``family.extract``), saved in the npz manifest format of
``checkpoint.io`` (which both packages read and write) with a JSON sidecar
that names the spec and prices the artifact against the edge fleet
(train-step seconds from the latency LUT, an analytic decode-step
estimate per device profile). ``load_submodel`` restores it without the
parent: the restore template is built on ``torch.device("meta")`` by the
family's ``init_params`` and ``extract`` (the port's form of
``jax.eval_shape``), so no parent parameter is materialised.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.checkpoint.io import (load_metadata, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.core.latency import EDGE_FLEET, DeviceProfile, LatencyTable
from repro_torch.core.submodel import SubmodelSpec, TransformerSubSpec
from repro_torch.kernels.backend import resolve_device


# ---------------------------------------------------------------------------
# spec <-> JSON payload (the sidecar's spec identity)
# ---------------------------------------------------------------------------
def spec_payload(spec) -> Dict[str, Any]:
    """JSON-able dict naming ``spec`` (inverse: :func:`payload_spec`)."""
    if isinstance(spec, TransformerSubSpec):
        return {"kind": "transformer",
                "layers": [list(k) for k in spec.layers],
                "ff_frac": spec.ff_frac,
                "expert_frac": spec.expert_frac,
                "ssm_head_frac": spec.ssm_head_frac,
                "attn_head_frac": spec.attn_head_frac}
    if isinstance(spec, SubmodelSpec):
        return {"kind": "cnn", "depth": list(spec.depth),
                "width": list(spec.width)}
    raise TypeError(f"unknown spec type {type(spec).__name__}")


def payload_spec(payload: Dict[str, Any]):
    if payload["kind"] == "transformer":
        return TransformerSubSpec(
            layers=tuple(tuple(k) for k in payload["layers"]),
            ff_frac=payload["ff_frac"],
            expert_frac=payload["expert_frac"],
            ssm_head_frac=payload["ssm_head_frac"],
            attn_head_frac=payload["attn_head_frac"])
    if payload["kind"] == "cnn":
        return SubmodelSpec(depth=tuple(payload["depth"]),
                            width=tuple(payload["width"]))
    raise ValueError(f"unknown spec payload kind {payload['kind']!r}")


# ---------------------------------------------------------------------------
# export / load
# ---------------------------------------------------------------------------
def _price(family, spec, fleet: Sequence[DeviceProfile]) -> Dict[str, Any]:
    """Per-device cost rows: the LUT's train-step seconds and an analytic
    single-token decode-step estimate (per-token FLOPs, a full read of the
    parameters)."""
    lut = LatencyTable(family, fleet=fleet)
    flops = family.flops(spec)
    pbytes = family.param_bytes(spec)
    seq = getattr(family, "seq_len", 1) or 1
    return {prof.name: {
        "train_step_s": lut.lookup(spec, prof.name),
        "decode_step_ms": 1e3 * prof.step_latency(flops / seq, pbytes),
    } for prof in fleet}


def export_submodel(family, params, spec, path: str, *,
                    fleet: Sequence[DeviceProfile] = EDGE_FLEET
                    ) -> Dict[str, Any]:
    """Extract ``spec``'s dense submodel from the parent ``params`` and save
    it at ``path`` (npz + ``.meta.json`` sidecar). Returns the metadata."""
    sub_params, _ = family.extract(params, spec)
    meta = {
        "family": family.name,
        "arch": getattr(family.cfg, "name", type(family.cfg).__name__),
        "spec": spec_payload(spec),
        "flops": family.flops(spec),
        "flops_fraction": family.flops_fraction(spec),
        "param_bytes": family.param_bytes(spec),
        "latency": _price(family, spec, fleet),
    }
    save_checkpoint(path, sub_params, metadata=meta)
    return meta


def load_submodel(family, path: str, spec=None,
                  device=None) -> Tuple[Any, Any, Dict[str, Any]]:
    """Load an exported submodel: ``(sub_params, sub_ctx, metadata)``, the
    parameters on ``device`` (the card unless the caller asks for the
    CPU). ``spec`` defaults to the sidecar's; the restore template lives
    on the ``meta`` device, so no parent parameter is built."""
    dev = resolve_device(device)
    meta = load_metadata(path)
    if spec is None:
        spec = payload_spec(meta["spec"])
    template = family.extract(
        family.init_params(seed=0, device=torch.device("meta")), spec)[0]
    return (restore_checkpoint(path, template, device=dev),
            family.sub_ctx(spec), meta)
