"""Idle share of the card in the traced stretch of a genome-wide map:
100 minus the union of its device operations' time over the stretch."""


def read(outcome, cell):
    st = outcome.stretch
    if st is None or outcome.facts.get("kind") != "predict":
        return None
    return 100.0 * (1.0 - st.busy_seconds() / st.seconds)
