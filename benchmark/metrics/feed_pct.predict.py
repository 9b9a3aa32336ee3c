"""Share of a genome-wide map's traced stretch that its main thread
spent feeding the card: the summed ``genome.feed`` spans (the next batch
from the iterator, a chunk's upload on its first batch, the starts' copy
to the device) over the main loop's interval."""

from harness import program_spans


def read(outcome, cell):
    if outcome.facts.get("kind") != "predict":
        return None
    got = program_spans.first_session("genome.feed")
    return None if got is None else got.share("genome.feed")
