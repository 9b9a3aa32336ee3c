"""Host time to issue one train step: the summed ``train.group`` spans
of a train cell's traced stretch (a CUDA graph replay of K steps, or K
eager steps) over the steps they hold, in ms.  Where the card sets the
pace this includes the wait for room in the launch queue."""

from harness import program_spans


def read(outcome, cell):
    if outcome.facts.get("kind") != "train":
        return None
    got = program_spans.first_session("train.group")
    if got is None:
        return None
    groups = got.named("train.group")
    steps = sum(r.attrs["steps"] for r in groups)
    return 1e-6 * got.summed_ns("train.group") / steps if steps else None
