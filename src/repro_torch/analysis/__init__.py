"""Concurrency correctness toolkit.

- :mod:`repro_torch.analysis.static_check` — AST lock-discipline pass (layer 1),
  run via ``python -m repro_torch.analysis.concheck``.
- :mod:`repro_torch.analysis.sanitizer` — instrumented lock shim + dynamic
  lock-order graph (layer 2), activated by ``REPRO_SANITIZE=1`` or
  ``sanitizer.enable()``.
- :mod:`repro_torch.analysis.schedules` — seeded schedule perturbation that turns
  the test suite into a race fuzzer.
"""

from repro_torch.analysis import sanitizer, schedules, static_check  # noqa: F401
