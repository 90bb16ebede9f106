"""K4_roofline: K4's least time over its measured device time in the
window.  The work is the cell's: one launch per k-block of the layers
after the first and one k=1 launch per remainder layer, 20 bytes a cell."""

from wavebench import roofline

KERNELS = ("kstep_comp_pipe_kernel",)


def read(rec):
    if "kernels" not in rec:
        return None
    layers, k = rec["timesteps"] - 1, rec["k"]
    launches = rec["solves"] * roofline.kstep_launches(layers, k, True)
    bound = roofline.bound_seconds("K4", rec["N"] ** 3, launches,
                                   rec["solves"] * layers)
    return roofline.share_pct(bound, roofline.device_seconds(rec, KERNELS))
