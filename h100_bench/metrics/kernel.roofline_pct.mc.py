"""Kernel: the synthesis kernel's share of its roofline in the Monte-Carlo cells,
in %: the least time the card could take for the rows it synthesized
(harness.opmodel, counted from the scenario's work and divided by the
H100's published peaks) over the kernel's device time in the trace."""

from harness import opmodel


def read(run):
    if run.kind != "batch" or not run.work:
        return None
    seconds = run.device_seconds(lambda name: "synth_blocks" in name)
    if seconds <= 0:
        return None
    return 100.0 * opmodel.bound_seconds(run.work) / seconds
