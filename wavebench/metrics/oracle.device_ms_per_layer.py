"""oracle.device_ms_per_layer: device time of every kernel that is not one
of the port's own CUDA kernels (those of wavetpu_torch/kernels/csrc, named
below) in the window, divided by the layers the window's solves marched.
On the 1-step path that is the plain error pass; on the k-fused paths the
error rows come from the k-step kernels and this reads the small
reductions left around them."""

CSRC_KERNELS = frozenset((
    "step_kernel", "comp_step_kernel", "kstep_pipe_kernel",
    "kstep_comp_pipe_kernel", "sharded_step_kernel", "sharded_comp_kernel",
    "sharded_lanes_kernel",
))


def read(rec):
    if "kernels" not in rec or not rec.get("solves"):
        return None
    other = sum(v[1] for n, v in rec["kernels"].items()
                if n not in CSRC_KERNELS)
    return 1e3 * other / (rec["solves"] * rec["timesteps"])
