"""The reference's plan of the planned dispatch: for each step that the
program planned on the host, what fmov_pose's per-step loop decides for
it, worked out again from the configuration, the step count and the
frames the step drew.

The curriculum of phase 1 (``confs/ho3d_virtual.conf``): from
``current_image`` admitted frames, one more every ``max_pro_iteration``
steps; at each admission every segment is frozen but the new one, and
``pro_warm_up_end`` steps later every admitted segment trains again.  A
step's learning rate is the linear warm-up then the cosine of the
schedule; each segment's pose learning rate the cosine over the steps
that touched it (``max_pro_iteration`` of them a period, down to
``pose_alpha``).  The draws (the frame, the maintain_shape frame, the
flow coin, the flow partner and the match pixels) are the program's, and
only held to what the loop can draw: admitted frames, a partner among
the frame's flow pairs within ``flow_interval``, flow only near the
newest frame, pixels among the pair's matches.

A row as the program packs it: 9 scalars (learning rate, cos-anneal
ratio, main and pose update gates, the mask-guide flag, the translation
head gate, the frame, the maintain_shape frame, the flow frame), then a
segment's touch, freeze gate and pose learning rate, each [S].
"""

from __future__ import annotations

import math

import numpy as np

N_HEAD = 9
REL = 1e-6  # a learning rate: the same f64 formula rounded to f32


def main_lr(t: dict, it: int) -> float:
    if it < t["warm_up_end"]:
        factor = it / t["warm_up_end"]
    else:
        progress = (it - t["warm_up_end"]) / (t["end_iter"] - t["warm_up_end"])
        factor = (math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - t["learning_rate_alpha"]) \
            + t["learning_rate_alpha"]
    return float(t["learning_rate"] * factor)


def _match_keys(xs1, ys1, xs2, ys2):
    """One number a match (x1, y1, x2, y2): the pixels as the program
    holds them (f32, three decimals), in thousandths, two to a part."""
    k = np.rint(np.stack([xs1, ys1, xs2, ys2], -1).astype(np.float32).astype(np.float64)
                * 1000.0).astype(np.int64)
    return ((k[:, 0] << 20) + k[:, 1]).astype(np.float64) \
        + 1j * ((k[:, 2] << 20) + k[:, 3]).astype(np.float64)


def plan(t: dict, scene, rows) -> tuple:
    """(steps, faults) for ``rows`` = [(packed, use_flow, pixels or None)],
    every step the program planned, from its first.  ``t``: the
    configuration's ``train`` keys.  ``steps``: each step's decisions for
    the reference (the learning rates, gates, touch and freeze worked out
    here; frames and pixels as drawn).  ``faults``: one line for each
    step whose row differs from them, or whose draws the loop cannot
    make."""
    n_images = scene.images_np.shape[0]
    seg_len = t.get("image_interval", 1)
    S = -(-n_images // seg_len)
    max_pro, pro_warm = t["max_pro_iteration"], t["pro_warm_up_end"]
    flow_int = t["flow_interval"]
    warmup_mesh = t.get("mesh_warmup_step", 0)
    current = min(t.get("current_image", n_images), n_images)
    pro, index = 0, 0
    frozen = np.ones(S, np.float32)
    progress = np.zeros(S, np.float64)
    keys = {}
    steps, faults = [], []
    for it, (packed, use_flow, pix) in enumerate(rows):
        packed = np.asarray(packed, np.float32)
        if packed.shape[0] != N_HEAD + 3 * S:
            faults.append(f"step {it}: a row of {packed.shape[0]} for {S} segments")
            break
        img, add, corr = (int(v) for v in packed[6:9])
        use_flow = bool(use_flow)
        bad = []
        if not 0 <= img < current or (t["maintain_shape"] and not 0 <= add < current):
            bad.append(f"frames {img}, {add} of {current} admitted")
        if use_flow:
            if not 0 <= corr < current or abs(corr - current) >= flow_int \
                    or current == n_images:
                bad.append(f"flow from frame {corr} with {current} admitted")
            name_c, name = scene.index_to_frame.get(corr), scene.index_to_frame.get(img)
            if name not in scene.flow_pairs.get(name_c, ()) or abs(img - corr) > flow_int:
                bad.append(f"flow partner {img} of frame {corr}")
            else:
                pair = f"{name_c}_{name}"
                if pair not in keys:
                    keys[pair] = np.sort(_match_keys(*scene.loftr_flows[pair]))
                p = np.asarray(pix, np.float32).reshape(-1, 4)
                if not np.isin(_match_keys(*p.T), keys[pair]).all():
                    bad.append(f"pixels not among the matches of {pair}")
        in_warmup = it < warmup_mesh
        touched = sorted({f // seg_len for f in [img] + ([corr] if use_flow else [])
                          + ([add] if t["maintain_shape"] else [])})
        touched = [s for s in touched if s < S]
        touch = np.zeros(S, np.float32)
        touch[touched] = 1.0
        progress[touched] += 1
        factor = (np.cos(np.pi * progress / max(max_pro, 1)) + 1.0) * 0.5 \
            * (1 - t["pose_alpha"]) + t["pose_alpha"]
        main = 0.0 if (t.get("detach_mesh_at_warm_up", False) and it > warmup_mesh
                       and pro < pro_warm and index in touched) else 1.0
        step = {
            "lr": main_lr(t, it),
            "cos_anneal": 1.0 if t["anneal_end"] == 0 else min(1.0, it / t["anneal_end"]),
            "main_update": main, "pose_update": 0.0 if in_warmup else 1.0,
            "mask_guided": 1.0 if (t["mask_guided_sampling"] and not in_warmup) else 0.0,
            "trans_head_on": 0.0 if (t.get("disable_trans_during_warm_up", False)
                                     and pro < pro_warm) else 1.0,
            "touch": touch, "freeze": frozen.copy(),
            "seg_lr": (t["pose_lr"] * factor).astype(np.float32),
            "img": img, "add": add, "corr": corr, "flow": use_flow,
            "pixels": None if not use_flow else np.asarray(pix, np.float32).reshape(-1, 4),
        }
        head = np.array([step[k] for k in ("lr", "cos_anneal", "main_update", "pose_update",
                                           "mask_guided", "trans_head_on")], np.float32)
        if not np.allclose(packed[:6], head, rtol=REL, atol=0):
            bad.append(f"scalars {packed[:6].tolist()}, the reference's {head.tolist()}")
        for name, off, want, exact in (("touch", 0, touch, True),
                                       ("freeze", S, step["freeze"], True),
                                       ("pose lr", 2 * S, step["seg_lr"], False)):
            got = packed[N_HEAD + off:N_HEAD + off + S]
            if not (np.array_equal(got, want) if exact
                    else np.allclose(got, want, rtol=REL, atol=0)):
                bad.append(f"{name} {got.tolist()}, the reference's {want.tolist()}")
        if bad:
            faults.append(f"step {it}: " + "; ".join(bad))
        steps.append(step)
        # the step count and the curriculum's events after the step
        if it + 1 > warmup_mesh and pro >= 0:
            pro += 1
            if pro == max_pro:
                pro = 0
                prev, current = current, min(current + seg_len, n_images)
                if current > prev:
                    index += 1
                    frozen[:] = 0.0
                    if index < S:
                        frozen[index] = 1.0
                else:
                    pro = -1
            if pro == pro_warm:
                frozen[:index + 1] = 1.0
    return steps, faults
