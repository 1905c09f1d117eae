"""The port under the repo's architecture lint, and under its own.

``repro.analysis.staticcheck.archlint`` walks all of ``src/``, so the port
is held to the same rules as the JAX package: no process-global
``lru_cache`` state, packed-word arithmetic only under ``kernels/bitset/``,
no unused imports, no orphan modules. The port's own archlint
(``repro_torch.analysis.staticcheck.archlint``) holds the same seven rules
over ``src/repro_torch/`` with ``chip_smoke.py`` among its roots. These
tests read the source tree only, so each runs in about two seconds.
"""
import pathlib

import pytest

pytest.importorskip("torch")

from repro.analysis.staticcheck import archlint  # noqa: E402
from repro_torch.analysis.staticcheck import archlint as port_archlint  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_has_no_lint_finding():
    found = [f for f in archlint.run(str(REPO_ROOT))
             if f.path.startswith("src/repro_torch/")]
    assert found == [], "\n".join(str(f) for f in found)


def test_port_has_no_finding_under_its_own_archlint():
    found = port_archlint.run(str(REPO_ROOT))
    assert found == [], "\n".join(str(f) for f in found)
