"""``step_mfu``: the model's operations in the window's steps, over the
window's seconds, over the bf16 dense peak (``work.PEAK_FLOPS``), in %.
The operations are a step's fields' work from the shapes
(``work.step_flops``: the up-sampler's queries, the SDF forward, input
gradient and second-order backward, the color forward and backward, and
with a NeRF++ background the ``nerf`` network's forward and backward at
every inside and outside sample), nothing recomputed; the same peak
whatever the cell's precision."""


def read(run):
    if run.window_s <= 0 or not run.window_steps:
        return None
    return 100.0 * run.step_flops * run.window_steps / run.window_s / run.work.PEAK_FLOPS
