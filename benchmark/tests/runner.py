"""``benchmark/run.py``'s ``result_line`` and ``report`` for the tests (run.py is a
script, loaded by its path)."""

import importlib.util

from benchmark import harness

_spec = importlib.util.spec_from_file_location("benchmark_run",
                                               harness.HERE / "run.py")
_run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_run)
result_line = _run.result_line
report = _run.report
