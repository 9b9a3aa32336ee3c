"""K5's share of its roofline in a train cell: the least time the card
needs for the bytes of the train-mode BatchNorms that K5 runs in the
traced stretch's steps (five float32 passes an element, counted from the
shapes: ``harness/bn_work.py``), over the summed device time of K5's
kernels there.  Nothing to read where no K5 kernel ran."""

from harness import bn_work, flops

# every K5 kernel's name starts so (ops/csrc/batch_norm.cu)
KERNEL = "k5_bn_"


def read(outcome, cell):
    st = outcome.stretch
    if st is None or outcome.facts.get("kind") != "train":
        return None
    seconds, calls = st.kernel_seconds(KERNEL)
    if not calls or not st.units:
        return None
    n_bytes = bn_work.train_bytes(cell.config, cell.traffic,
                                  outcome.facts["batch"]) * st.units
    least, _ = flops.least_seconds(n_bytes, 0)
    return 100.0 * least / seconds
