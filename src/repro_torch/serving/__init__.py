"""Serving: the batched decode engine (CUDA-graph step cache), requests and
routing policies."""
from repro_torch.serving.engine import DecodeEngine, GenerationResult
from repro_torch.serving.request import ServeRequest, ServeResult
from repro_torch.serving.router import (DEFAULT_ACCURACY, CostAwarePolicy,
                                        RoutingPolicy, StaticPolicy,
                                        TierPolicy, head_eligible,
                                        route_requests)

__all__ = ["DecodeEngine", "GenerationResult", "ServeRequest", "ServeResult",
           "RoutingPolicy", "StaticPolicy", "TierPolicy", "CostAwarePolicy",
           "DEFAULT_ACCURACY", "head_eligible", "route_requests"]
