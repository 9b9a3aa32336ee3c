"""Share of a genome-wide map's traced stretch that its drain thread
spent blocked on the output farm: the summed ``farm.queue_wait`` spans (a
submit waiting for room in the workers' full task queue) over the
main loop's interval.  0 where the farm runs inline."""

from harness import program_spans


def read(outcome, cell):
    if outcome.facts.get("kind") != "predict":
        return None
    got = program_spans.first_session("genome.feed")
    return None if got is None else got.share("farm.queue_wait")
