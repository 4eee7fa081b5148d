"""repro_torch — the L2S screened-softmax decode path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).

This package mirrors ``src/repro/`` (the JAX reference) module for module:
each module's reference is its twin at the same path. It imports ``torch``
and never ``jax`` or ``repro``; ``repro_torch.interop`` takes the reference's
weights as numpy arrays.

Entry points (``DecodeEngine``, ``heads.get``, ``Model.init``) run on
``device="cuda"`` unless the caller passes ``device="cpu"``; without a GPU the
default raises (see ``repro_torch.device.resolve_device``).
"""
