"""dcfm-lint for the port: the AST lint in torch idiom, and a trace gate
over the port's graphed trips.

The port of ``dcfm_tpu/analysis/``, importing nothing of it:

* **the AST lint** (``linter.py``, ``locks.py``, ``lifetime.py``,
  ``engine.py``, ``baseline.py``, ``rules.RULES``): the JAX registry's
  thirty ids, families, severities and scopes.  Fifteen are the JAX
  detectors unchanged (the same findings on the same source); fifteen
  (``rules.TRANSLATED``) match the torch spelling of their hazard - the
  global RNG stream, host syncs / branches / environment reads / float64
  in code a CUDA-graph capture reaches (across modules, through the
  engine's call graph), rank-branch collectives, blocking fetches in
  ``runtime/``, ``from_numpy`` aliases copied asynchronously, torch
  allocations and bf16 products, process groups outside ``parallel/``,
  live device counts in resume arithmetic.  ``--gate`` lints the port's
  own files against ``analysis/lint_baseline.json``.
* **the trace gate** (``registry.py``, ``tracecheck.py``,
  ``rules.TRACE_RULES``): the JAX gate traces jaxprs; this one runs each
  registered entry of the port once under a recording
  ``TorchDispatchMode`` and checks the aten ops it dispatched - the
  collective groups of the mesh's seam (DCFM1801/1802/1808), dtype leaks
  (1803/1804), host syncs (1805), in-place carries (1806), stable static
  keys (1807), and no variate drawn or CUDA event touched inside a
  sweep-body entry (1809: the graphs replay their Philox offsets).
* **test-isolated** (``isolate.py``): one pytest subprocess per file.

Run it as ``dcfm-tpu-torch lint <paths>`` or ``python -m
dcfm_tpu_torch.analysis``; ``--trace`` for the gate (on the card by
default, ``--device cpu`` on the CPU).  Suppress a single finding with an
inline ``# dcfm-torch: ignore[RULE_ID] - <why>`` comment on the flagged
line (the JAX form ``# dcfm: ignore[...]`` is read too, and is the one to
use where both linters fire).  Importing this package (and
``registry.py``) imports no torch.
"""

from dcfm_tpu_torch.analysis.linter import (
    Finding, lint_file, lint_paths, lint_source)
from dcfm_tpu_torch.analysis.rules import RULES, Rule

__all__ = [
    "Finding", "RULES", "Rule", "lint_file", "lint_paths", "lint_source",
    "lint_project", "main",
]


def lint_project(paths, **kwargs):
    """Project-aware lint (cross-module symbol table, optional cache /
    changed-only selection); see analysis/engine.py."""
    from dcfm_tpu_torch.analysis.engine import lint_project as _lp
    return _lp(paths, **kwargs)


def main(argv=None) -> int:
    from dcfm_tpu_torch.analysis.__main__ import main as _main
    return _main(argv)
