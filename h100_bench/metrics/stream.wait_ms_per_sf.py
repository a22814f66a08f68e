"""runtime/stream: ms the consumer waits in the stream's generator for
each superframe delivered (host clock, the benchmark's span around
next() on the window's streams)."""


def read(run):
    seconds, units, _ = run.rec.total("stream.wait")
    if units <= 0:
        return None
    return seconds / units * 1e3
