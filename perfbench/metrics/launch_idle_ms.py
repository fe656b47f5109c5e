"""``launch_idle_ms`` (optimizer loop): ms a traced frame of the device's
idle time inside the program's ``ebt.loop`` spans, the gaps between a
loop's replays, apart from the host work around the loops.  The spans and
the device's records share the profiler's clock."""

from perfbench import timeline


def read(run):
    if run.trace is None or not run.traced:
        return None
    loops = [(a.start, a.end) for a in run.trace.host if a.name == "ebt.loop"]
    if not loops:
        return None
    device = [(a.start, a.end) for a in run.trace.device]
    # the loops' time that no device record covers: |loops ∪ device| − |device|
    idle = (timeline.union_length(loops + device, *run.trace.window)
            - timeline.union_length(device, *run.trace.window))
    return idle * 1e3 / len(run.traced)
