"""The repo's static analysis (``tools/analysis``) over the port: each of
its passes reports no finding on ``paddle_tpu_torch/``, the same bar
``tests/test_static_analysis.py`` holds the JAX package to.  A site that
is right as written carries the pass's own marker (``# lint-ok: <rule>
<reason>``, ``# silent-ok:``, ``# rank-ok:``) with its reason.

The one parse of the tree is shared by the cases; there is no wall
budget (``python -m tools.analysis --root paddle_tpu_torch`` runs the
same scan from the command line)."""
from __future__ import annotations

import os
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.analysis.core import REGISTRY, Project, run_pass  # noqa: E402
from tools.analysis import passes as _passes  # noqa: E402,F401  (registers)

RULES = ["atomic-writes", "metric-names", "fault-sites",
         "collective-instrumented", "bounded-retries", "excepts",
         "span-discipline", "lock-discipline", "trace-purity",
         "collective-discipline", "sharding-spec"]


@pytest.fixture(scope="module")
def project():
    return Project(package_root=os.path.join(REPO, "paddle_tpu_torch"))


def test_every_pass_is_scanned():
    assert set(RULES) == set(REGISTRY)


def test_the_port_is_the_tree_scanned(project):
    rels = {m.rel for m in project.modules()}
    assert len(rels) > 100
    assert all(r.startswith("paddle_tpu_torch/") for r in rels)
    assert "paddle_tpu_torch/distributed/collective.py" in rels


@pytest.mark.parametrize("rule", RULES)
def test_pass_finds_nothing_in_the_port(project, rule):
    new, _, _ = run_pass(REGISTRY[rule], project)
    assert new == [], "\n".join(str(f) for f in new)
