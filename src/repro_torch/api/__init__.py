"""The port's public entry point: `GraphSession` (``open`` → ``compile`` →
``run`` / ``stream``), the counterpart of ``repro.api``."""
from repro_torch.api.compiled import CompiledQuery
from repro_torch.api.session import GraphSession

__all__ = ["CompiledQuery", "GraphSession"]
