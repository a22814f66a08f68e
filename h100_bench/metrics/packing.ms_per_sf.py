"""Packing: ms of IqStream._prepare_group (pack_plan, build_group_params,
the C/A tables and the superframe map) per superframe prepared (host
clock, the benchmark's span on each stream instance)."""


def read(run):
    seconds, units, _ = run.rec.total("packing.prepare_group")
    if units <= 0:
        return None
    return seconds / units * 1e3
