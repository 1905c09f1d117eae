"""PyTorch/CUDA port of the STwig subgraph matcher (``repro``, JAX/TPU).

Same layout and names as ``repro``: `graphstore`, `core`, `kernels/<op>`,
`runtime`, `api`. Entry point: `repro_torch.api.GraphSession`. The port
imports neither ``jax`` nor ``repro``.
"""
