"""Test set-up of the benchmark's directory, loaded before its tests are
collected.

``faults.FOR_LOOP`` names the faults that the check must catch by the
traffic mix at the end of a workload's name; ``tests/test_gpubench_checks.py``
plants them in every cell of BENCHMARK.json.  The Kerr cell's mix,
``fit_kerr``, runs the fit loop's steps (``loops/fit_kerr.py``), so it
must catch the fit mix's faults: they are entered for it here, since
``faults.py`` is the benchmark's and stays as it is.
"""

from gpubench import faults

faults.FOR_LOOP.setdefault("fit_kerr", faults.FOR_LOOP["fit"])
