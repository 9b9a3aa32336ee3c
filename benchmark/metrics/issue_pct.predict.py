"""Share of a genome-wide map's traced stretch that its main thread
spent issuing the forward: the summed ``genome.issue`` spans (the
window encode and the forward's enqueue, K1's launches included, for
every replica) over the main loop's interval.  Where the card sets the
pace this includes the wait for room in the launch queue."""

from harness import program_spans


def read(outcome, cell):
    if outcome.facts.get("kind") != "predict":
        return None
    got = program_spans.first_session("genome.feed")
    return None if got is None else got.share("genome.issue")
