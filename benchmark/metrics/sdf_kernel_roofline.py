"""``sdf_kernel_roofline``: the SDF network's least time a step
(``work.field_least_s``: the up-sampler's queries, the forward with the
input gradient, the second-order backward, each call bounded by the
larger of its operations over the bf16 peak and its bytes over the
memory rate) over the device time a step of the kernels that compute it,
in %.

The kernels are picked by name: K1-K5 of ``fmov_pose_torch/ops`` (in a
captured step their ``fmov::K*`` profiler ranges are not replayed), and
the weight-gradient stage (``wgrad_kernel``, ``reduce_kernel``) counted
to the kernel that ran last before it on its stream.  A later program
that renames one of these kernels leaves this metric silent or low until
the next benchmark change repoints it."""

MEMBERS = {"sdf_fwd_kernel": "sdf", "sdf_fwd_grad_flat_kernel": "sdf",
           "sdf_bwd_flat_kernel": "sdf", "sdf_fwd_grad_kernel": "sdf",
           "sdf_bwd_kernel": "sdf",
           "color_sample_fwd_kernel": "color", "color_sample_bwd_kernel": "color",
           "color_fwd_kernel": "color", "composite_kernel": "color",
           "color_bwd_kernel": "color"}
STAGE = ("wgrad_kernel", "reduce_kernel")
FIELD = "sdf"


def read(run):
    seconds = run.trace.family_seconds(MEMBERS, STAGE).get(FIELD, 0.0)
    if seconds <= 0 or not run.trace.steps:
        return None
    least = run.work.field_least_s(run.model, run.rays_per_step, FIELD)
    return 100.0 * least * run.trace.steps / seconds
