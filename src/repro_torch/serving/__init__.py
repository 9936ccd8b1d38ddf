"""Elastic serving — multi-tenant masked decode (``serving.server``) over
the continuous-batching scheduler (``serving.batcher``). Export and
cold-start distillation come with a later slice (ROADMAP A15)."""
from repro_torch.serving.batcher import Completion, ContinuousBatcher, Request
from repro_torch.serving.server import EdgeServer

__all__ = ["Completion", "ContinuousBatcher", "Request", "EdgeServer"]
