"""K1_roofline: K1's least time over its measured device time in the
window.  The work is the cell's: one launch per marched layer after the
first (the first comes from the closed form), 12 bytes a cell."""

from wavebench import roofline

KERNELS = ("step_kernel",)


def read(rec):
    if "kernels" not in rec:
        return None
    steps = rec["solves"] * (rec["timesteps"] - 1)
    bound = roofline.bound_seconds("K1", rec["N"] ** 3, steps, steps)
    return roofline.share_pct(bound, roofline.device_seconds(rec, KERNELS))
