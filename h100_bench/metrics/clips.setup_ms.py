"""Control plane: ms from a clip's request to its IqStream being built
(scenario set-up, the first channel allocation and nav messages), per
clip (host clock, the benchmark's span)."""


def read(run):
    seconds, _, calls = run.rec.total("clips.init")
    if calls <= 0:
        return None
    return seconds / calls * 1e3
