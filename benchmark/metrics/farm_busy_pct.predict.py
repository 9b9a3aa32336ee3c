"""How busy the output farm's workers were in a genome-wide map's traced
stretch: the seconds the workers spent on the chunks written inside the
main loop's interval (the ``farm.worker_busy_s`` counter, each worker
timing its own chunk), over the workers times the interval.  Inline, the
summed ``farm.inline`` spans, clipped to the interval, over it."""

from harness import program_spans


def read(outcome, cell):
    if outcome.facts.get("kind") != "predict":
        return None
    got = program_spans.first_session("genome.feed")
    if got is None:
        return None
    busy = got.named("farm.worker_busy_s")
    if busy:
        workers = busy[0].attrs["workers"]
        return (100.0 * sum(r.value for r in busy)
                / (workers * got.wall_ns / 1e9))
    if got.named("farm.inline"):
        return got.share("farm.inline")
    return None
