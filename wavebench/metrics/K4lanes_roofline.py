"""K4lanes_roofline: K4's least time in its lane mode over its measured
device time in a serving window.  The work is the window's batches': one
launch per k-block of the layers after the first and one k=1 launch per
remainder layer, each over the lanes the kernel marched (the real lanes:
padding lanes stop at layer 1 and enter no K4 launch), 20 bytes a held
cell a launch (roofline/K4.json: the lane mode moves each lane's u, v and
carry once a launch, as the solo kernel does its one)."""

from wavebench import roofline

KERNELS = ("kstep_comp_pipe_kernel",)


def read(rec):
    if "kernels" not in rec or not rec.get("lanes"):
        return None
    layers, k = rec["timesteps"] - 1, rec["k"]
    cells = rec["N"] ** 3 * sum(rec["lanes"])
    bound = roofline.bound_seconds(
        "K4", cells, roofline.kstep_launches(layers, k, True), layers)
    return roofline.share_pct(bound, roofline.device_seconds(rec, KERNELS))
