"""K3_roofline: K3's least time over its measured device time in the
window.  The work is the cell's: one launch per k-block of the layers
after the first (the remainder runs K1), 16 bytes a cell."""

from wavebench import roofline

KERNELS = ("kstep_pipe_kernel",)


def read(rec):
    if "kernels" not in rec:
        return None
    layers, k = rec["timesteps"] - 1, rec["k"]
    launches = rec["solves"] * roofline.kstep_launches(layers, k, False)
    steps = rec["solves"] * (layers // k) * k
    bound = roofline.bound_seconds("K3", rec["N"] ** 3, launches, steps)
    return roofline.share_pct(bound, roofline.device_seconds(rec, KERNELS))
