"""Plain references of the configurations' solves, one module each, found
by the ``reference`` key of a configuration file.

A reference module has ``FLOW_SIGN`` (what the facade's flow is times the
pattern displacement), ``trajectories(windows, solves, config, seed,
steps, device)`` (the first ``steps`` losses of each solve, in float64, NaN where a step is not
compared)
and ``assembly_faults(flow, config)``.  It imports neither JAX nor any
package of this repository.
"""
