"""K2's and K3's share of their roofline in a train cell: the least time
the card needs for the bytes and operations of their work in the traced
stretch (two calls of each per train step, counted from the shapes, each
kernel's bound taken apart), over the summed device time of their
kernels there (K3's partial-sum reduce included).  Nothing to read where
no K2 or K3 kernel ran."""

from harness import flops

KERNELS = ("code_conv_pool_fwd_kernel", "code_conv_pool_bwd_kernel",
           "reduce_partials_kernel")


def read(outcome, cell):
    st = outcome.stretch
    if st is None or outcome.facts.get("kind") != "train":
        return None
    timed = [st.kernel_seconds(k) for k in KERNELS]
    if not timed[0][1] or not st.units:
        return None
    B = outcome.facts["batch"]
    least = sum(flops.least_seconds(b * st.units, o * st.units)[0]
                for b, o in (flops.k2_work(cell.config, B),
                             flops.k3_work(cell.config, B)))
    return 100.0 * least / sum(s for s, _ in timed)
