"""The port's benchmark: ``python perfbench/run.py --workload <cell> …``
(see ``README.md``)."""
