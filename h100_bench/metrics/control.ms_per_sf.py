"""Control plane: ms of Scheduler.plan_group on the planner thread per
superframe planned (host clock, the benchmark's span around the call on
each stream's own scheduler)."""


def read(run):
    seconds, units, _ = run.rec.total("control.plan_group")
    if units <= 0:
        return None
    return seconds / units * 1e3
