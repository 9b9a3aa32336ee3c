"""K1's share of its roofline in a genome-wide map: the least time the
card needs for the bytes and operations of K1's work in the traced
stretch (two calls per predict batch, counted from the shapes), over
the summed device time of K1's kernel there.  Nothing to read where no
K1 kernel ran."""

from harness import flops

KERNEL = "code_conv1d_kernel"


def read(outcome, cell):
    st = outcome.stretch
    if st is None or outcome.facts.get("kind") != "predict":
        return None
    seconds, calls = st.kernel_seconds(KERNEL)
    if not calls or not st.units:
        return None
    n_bytes, n_ops = flops.k1_work(cell.config, outcome.facts["batch"])
    least, _ = flops.least_seconds(n_bytes * st.units, n_ops * st.units)
    return 100.0 * least / seconds
