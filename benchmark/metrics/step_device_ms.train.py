"""Device time of one train step: the summed duration of the device
operations in the traced stretch over the steps it holds, in ms."""


def read(outcome, cell):
    st = outcome.stretch
    if st is None or outcome.facts.get("kind") != "train" or not st.units:
        return None
    return 1e3 * st.device_seconds() / st.units
