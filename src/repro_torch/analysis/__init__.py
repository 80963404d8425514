"""The port's own static checker (``repro-torch-lint``).

Counterpart of the reference's ``repro/analysis``, kept inside the port
(which imports nothing of the reference) and read over the port's own
module map: files under a ``repro_torch`` directory, ``tests``,
``benchmarks``, ``examples``, and ``chip_smoke.py``.  The port's
correctness rests on invariants no general-purpose linter knows about:

* **Twin boundary (RPT1xx)**: in-situ learning sees only observable chip
  state.  Twin-internal ground truth (``repro_torch.hw``'s ``twin`` /
  ``device`` / ``drift`` / ``jobs`` / ``server`` internals) stays behind
  ``driver.unsafe_twin()``, whose call sites are restricted to an explicit
  diagnostic allowlist.
* **Wire trio (RPT2xx)**: ``BATCHABLE_OPS`` (``hw/driver.py``), the
  server's ``_dispatch`` (``hw/server.py``) and the ``StreamDriver``
  client (``hw/stream_driver.py``) agree on the ops and on the payload
  keys each side sends and reads, with the client's keys taken as its
  ``_wire_kw`` encoder leaves them and the server's reads followed one
  helper call deep.
* **Graph-capture and recompute safety (RPT3xx)**: no host sync or host
  state inside a body captured as a CUDA graph (``hw/jobs.py::_capture``,
  ``torch.cuda.graph``, ``capture_begin`` ... ``capture_end``) or re-run
  by ``torch.utils.checkpoint``, and no ``ptc_execution`` install there.
* **The CUDA kernels' C interface (RPT4xx)**: every ``ctypes``
  ``argtypes`` / ``restype`` in ``kernels/*.py`` matches the ``extern
  "C"`` signature in ``csrc/*.cu``, every entry point is bound, every
  ``build.KERNELS`` key is counted, and no ``try`` hides a kernel's
  failure behind a plain version.
* **Determinism (RPT5xx)**: seeds derive from configuration, never from
  wall clock or entropy; set iteration never feeds wire-frame
  construction.

Run it from the root of the checkout::

    PYTHONPATH=src python -m repro_torch.analysis.lint             # lint
    PYTHONPATH=src python -m repro_torch.analysis.lint --explain RPT401
    PYTHONPATH=src python -m repro_torch.analysis.lint --self-test

The default paths are ``src/repro_torch chip_smoke.py``.  Findings are
suppressed per line with ``# repro_torch: noqa[CODE]`` (``//`` in a CUDA
source) or grandfathered in a ``repro-torch-lint-baseline.json``
(``--update-baseline``).  The reference checker's ``# repro: noqa`` tag
hides nothing from this one.  The package is pure stdlib (``ast``,
``re``, ``json``, ``argparse``): it imports neither torch nor jax nor the
reference package, and runs anywhere.
"""

from .findings import Finding  # noqa: F401
from .engine import run_lint, all_rules, LintResult  # noqa: F401

__all__ = ["Finding", "run_lint", "all_rules", "LintResult"]
