"""Elastic serving — the deployment half of the CFL stack, three ways:

* ``serving.export`` — extract-and-serve: spec -> dense submodel
  checkpoint (npz manifest, priced by the latency cost model) -> load;
* ``serving.server`` + ``serving.batcher`` — multi-tenant masked decode
  over the continuous-batching scheduler;
* ``serving.distill`` — cold-start personalization: distil the parent
  into an unseen client's spec.
"""
from repro_torch.serving.batcher import Completion, ContinuousBatcher, Request
from repro_torch.serving.distill import distill_to_spec
from repro_torch.serving.export import (export_submodel, load_submodel,
                                        payload_spec, spec_payload)
from repro_torch.serving.server import EdgeServer

__all__ = ["Completion", "ContinuousBatcher", "Request", "EdgeServer",
           "distill_to_spec", "export_submodel", "load_submodel",
           "payload_spec", "spec_payload"]
