"""One reader per metric, found by the metric's name in BENCHMARK.json.

A reader has ``read(run)``, where ``run`` is the harness's
:class:`perfbench.harness.Run`, and returns the metric's value, or None
when the run holds nothing for it to read (the harness then leaves the
metric out of the result line).
"""
