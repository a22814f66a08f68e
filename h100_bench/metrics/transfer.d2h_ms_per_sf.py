"""Transfer: device ms of the copies of packed IQ to pinned host memory
per superframe dispatched (torch.profiler's CUDA trace, "Memcpy DtoH"
events, over the superframes the planner prepared)."""


def read(run):
    seconds = run.device_seconds(lambda name: "DtoH" in name)
    _, units, _ = run.rec.total("packing.prepare_group")
    if seconds <= 0 or units <= 0:
        return None
    return seconds / units * 1e3
