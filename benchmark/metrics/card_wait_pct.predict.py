"""Share of a genome-wide map's traced stretch that its drain thread
spent waiting on the card: the summed ``genome.card_wait`` spans (the
wait on a flush window's copies to the host), clipped to the main
loop's interval, over that interval."""

from harness import program_spans


def read(outcome, cell):
    if outcome.facts.get("kind") != "predict":
        return None
    got = program_spans.first_session("genome.feed")
    return None if got is None else got.share("genome.card_wait")
