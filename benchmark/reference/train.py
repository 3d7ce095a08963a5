"""The reference's training steps: the losses, the gated Adams and the
first steps of a cell, in plain PyTorch.

A step renders its ray batch (``model.render``) and assembles NeuS's
objective: the masked L1 color loss, the eikonal loss (weight
``igr_weight``), the mask's binary cross-entropy (``mask_weight``) and,
on a flow step, the fmov_pose flow loss: each half-batch's expected
surface points projected into the other frame against the matched pixels
(``flow_weight``).  ``maintain_shape`` adds a batch of rays of a second
frame.  The gradient goes to one Adam over every field leaf (and the
global pose net), and on a segment bank to one Adam a segment, stepped
only for the segments a step touches (``touch``), with a per-segment
learning rate and a 0/1 gate (``freeze``), the rotation-emphasis gate
holding the translation head still.

``scan_steps`` follows the scanned dispatch: a frame drawn uniformly from
the generator each step, the learning rate a function of the step count
(linear warm-up, then cosine).  ``planned_steps`` follows the steps of
the planned dispatch as ``benchmark.reference.plan`` works them out: the
learning rates and gates its own, the frames, flow pairs and pixels as
the program drew them.

Both run from the leaves ``init`` (by name), zero Adam moments and a
generator seeded with ``seed`` = (device, seed), and return what the
cell's check compares: each step's loss, each leaf's Adam first moment
after the last step (the gradients as the optimizer got them, gated) and
each leaf after the last step.  ``planned_steps`` also runs from a
state that the program reached (``state``: the Adam moments and step
counts; ``seed`` = (device, the generator's state)).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as M

B1, B2, EPS = 0.9, 0.999, 1e-8


def unflatten(items):
    root = {}
    for name, leaf in items:
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def adam_(p, g, mu, nu, lr, step):
    """One Adam step in place, the bias corrections in f32."""
    stepf = torch.tensor(float(step), dtype=torch.float32, device=p.device)
    mu.mul_(B1).add_(g, alpha=1 - B1)
    nu.mul_(B2).addcmul_(g, g, value=1 - B2)
    bc1 = 1 - torch.pow(B1, stepf)
    bc2 = 1 - torch.pow(B2, stepf)
    p.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + EPS))


def project(pts, c2w, K):
    w2c = M.invert(c2w)
    pix = (pts @ w2c[:3, :3].T + w2c[:3, 3]) @ K.T
    return pix[:, :2] / pix[:, 2:]


def _half(t, keep):
    return t if keep >= 1.0 else t[:int(t.shape[0] * keep)]


def losses_of(gen, params, cell, scene, data, cos_anneal, prec, flow=None):
    """The step's objective on ray batch ``data`` [N, 10]; ``flow`` =
    (pose of the frame, pose of its partner, K, K of the partner, pixels,
    partner's pixels) of a flow step, whose first 2 x len(pixels) rays are
    the partner's and the frame's match rays."""
    w = cell["weights"]
    rays_o, rays_d, true_rgb, mask = data[:, :3], data[:, 3:6], data[:, 6:9], data[:, 9:10]
    near, far = M.near_far(rays_o, rays_d)
    mask = (mask > 0.5).float() if w["mask"] > 0 else torch.ones_like(mask)
    out = M.render(gen, params, cell["model"], rays_o, rays_d, near, far, cos_anneal, prec)
    w_sum = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(mask * torch.log(w_sum) + (1.0 - mask) * torch.log(1.0 - w_sum))
    mask_sum = mask.sum() + 1e-5
    total = (torch.abs((out["color"] - true_rgb) * mask).sum() / mask_sum
             + out["eik_num"] / (out["eik_den"] + 1e-5) * w["igr"]
             + bce.sum() / float(rays_o.shape[0]) * w["mask"])
    if flow is not None:
        pose1, pose0, K1, K0, pix, pix_corr = flow
        n = rays_o.shape[0]
        pts = out["pts"].reshape(n, -1, 3)
        ns = pts.shape[1]
        wts = out["weights"][:, :ns]
        b2 = pix.shape[0]
        p0 = project(pts[:b2].reshape(-1, 3), pose1, K1).reshape(b2, ns, 2)
        err0 = ((p0 - pix[:, None, :]) * wts[:b2, :, None]).sum(dim=1)
        p1 = project(pts[b2:2 * b2].reshape(-1, 3), pose0, K0).reshape(b2, ns, 2)
        err1 = ((p1 - pix_corr[:, None, :]) * wts[b2:2 * b2, :, None]).sum(dim=1)
        total = total + (torch.abs(err0).mean() + torch.abs(err1).mean()) * w["flow"]
    return total


def _grads(loss, leaves):
    got = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
    return {n: (torch.zeros_like(t) if g is None else g)
            for (n, t), g in zip(leaves, got)}


def _fresh(leaves, device):
    return {n: t.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True)
            for n, t in leaves.items()}


def _moments(leaves, state=None):
    if state is None:
        return ({n: torch.zeros_like(t) for n, t in leaves.items()},
                {n: torch.zeros_like(t) for n, t in leaves.items()})
    return tuple({n: state[k][n].detach().to(t).clone() for n, t in leaves.items()}
                 for k in ("mu", "nu"))


def _generator(seed):
    """A generator on ``seed[0]`` seeded with ``seed[1]`` (an int), or set
    to that state."""
    gen = torch.Generator(device=seed[0])
    if isinstance(seed[1], int):
        gen.manual_seed(seed[1])
    else:
        gen.set_state(seed[1])
    return gen


def schedule_lr(cell, it):
    """The scanned steps' learning rate at step ``it``, in f32."""
    s = cell["schedule"]
    f32 = torch.float32
    it_f = torch.tensor(float(it), dtype=f32)
    warm = it_f / torch.tensor(max(s["warm_up_end"], 1.0), dtype=f32)
    progress = (it_f - s["warm_up_end"]) / torch.tensor(
        max(s["end_iter"] - s["warm_up_end"], 1.0), dtype=f32)
    alpha = s["learning_rate_alpha"]
    cosf = (torch.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
    return s["learning_rate"] * torch.where(it_f < s["warm_up_end"], warm, cosf)


def _result(losses, mu, leaves):
    return {"loss": losses, "mu": {n: m.detach().clone() for n, m in mu.items()},
            "final": {n: t.detach().clone() for n, t in leaves.items()}}


def scan_steps(cell, scene, init, pose_static, seed, n_steps, prec, keep=1.0):
    """``n_steps`` scanned photo steps of a global pose net (``gf``, its
    leaves under ``pose.``).  ``keep`` < 1 drops the rest of every ray
    batch (a fault the check must catch)."""
    dev = scene["images"].device
    gen = _generator(seed)
    leaves = _fresh(init, dev)
    mu, nu = _moments(leaves)
    losses = []
    n_images = scene["images"].shape[0]
    for it in range(n_steps):
        img_t = torch.randint(n_images, (1,), generator=gen, device=dev)
        img = int(img_t.item())
        params = unflatten(leaves.items())
        pose = M.pose_net(params["pose"], pose_static, img, cell["emphasize_rot"])
        data = M.random_rays(gen, scene, pose, img, cell["batch_size"], cell["patch"],
                             cell["mask_guided"])
        loss = losses_of(gen, params, cell, scene, _half(data, keep), 1.0, prec)
        grads = _grads(loss, list(leaves.items()))
        lr = schedule_lr(cell, it).to(dev)
        with torch.no_grad():
            for n, t in leaves.items():
                adam_(t, grads[n], mu[n], nu[n], lr, it + 1)
        losses.append(float(loss.detach()))
    return _result(losses, mu, leaves)


def planned_steps(cell, scene, init, bank_static, seed, steps, prec, keep=1.0, state=None):
    """The planned photo and flow ``steps`` (``plan.plan``'s) of a segment
    bank (``seg``, its leaves [S, ...] under ``bank.``); ``bank_static``:
    the bands ``b`` and each segment's ``init_c2w``; ``state``: None (zero
    moments and counts) or the moments ``mu``, ``nu`` by leaf, the flat
    Adam's ``step`` and the segments' ``seg_step`` [S]."""
    dev = scene["images"].device
    gen = _generator(seed)
    allv = _fresh(init, dev)
    leaves = {n: t for n, t in allv.items() if not n.startswith("bank.")}
    bleaves = {n: t for n, t in allv.items() if n.startswith("bank.")}
    mu, nu = _moments(allv, state)
    S = next(iter(bleaves.values())).shape[0]
    seg_steps = (torch.zeros(S, dtype=torch.int32, device=dev) if state is None
                 else state["seg_step"].to(device=dev, dtype=torch.int32).clone())
    step0 = 0 if state is None else state["step"]
    seg_len = cell["segment_img_num"]
    B = cell["batch_size"]
    losses = []
    for it, st in enumerate(steps):
        lr = torch.tensor(st["lr"], dtype=torch.float32, device=dev)
        img, add_img, img_corr = st["img"], st["add"], st["corr"]
        touch = torch.as_tensor(st["touch"], device=dev)
        freeze = torch.as_tensor(st["freeze"], device=dev)
        seg_lr = torch.as_tensor(st["seg_lr"], device=dev)
        params = unflatten(leaves.items())
        btrain = unflatten((n[5:], t) for n, t in bleaves.items())

        def pose(cam):
            s = cam // seg_len
            net = {k: {kk: vv[s] for kk, vv in v.items()} for k, v in btrain.items()}
            static = {"b": bank_static["b"][s], "init_c2w": bank_static["init_c2w"][s][None]}
            return M.pose_net(net, static, cam, cell["emphasize_rot"])

        guided = st["mask_guided"] > 0
        flow = None
        if st["flow"]:
            pairs = _half(torch.as_tensor(st["pixels"], device=dev), keep)
            pix_corr, pix = pairs[:, 0:2], pairs[:, 2:4]
            pose_c, pose1 = pose(img_corr), pose(img)
            parts = []
            for frame, pose_f, p in ((img_corr, pose_c, pix_corr), (img, pose1, pix)):
                ro, rd = M.pixels_to_rays(p[:, 0], p[:, 1], scene["intr_inv"][frame], pose_f)
                col = scene["images"][frame, p[:, 1].long(), p[:, 0].long()]
                parts.append(torch.cat([ro, rd, col, torch.ones_like(col[:, :1])], dim=-1))
            data = torch.cat(parts, dim=0)
            flow = (pose1, pose_c, scene["K"][img], scene["K"][img_corr], pix, pix_corr)
        else:
            data = _half(M.random_rays(gen, scene, pose(img), img, B, cell["patch"], guided),
                         keep)
        if cell["maintain_shape"]:
            extra = M.random_rays(gen, scene, pose(add_img), add_img, B, cell["patch"],
                                  guided)
            data = torch.cat([data, _half(extra, keep)], dim=0)
        loss = losses_of(gen, params, cell, scene, data, st["cos_anneal"], prec, flow)
        grads = _grads(loss, list(allv.items()))
        with torch.no_grad():
            for n, t in leaves.items():
                adam_(t, grads[n] * st["main_update"], mu[n], nu[n], lr, step0 + it + 1)
            seg_steps += touch.to(torch.int32)
            stepf = torch.clamp(seg_steps.float(), min=1.0)
            bc1, bc2 = 1 - torch.pow(B1, stepf), 1 - torch.pow(B2, stepf)
            for n, t in bleaves.items():
                shape = (S,) + (1,) * (t.dim() - 1)
                gate = freeze * st["pose_update"]
                if n.startswith("bank.lin3_trans."):
                    gate = gate * 0.0
                elif n.startswith("bank.lin3_scale."):
                    gate = gate * st["trans_head_on"]
                g = grads[n] * gate.view(shape)
                tt = touch.view(shape) > 0
                mu[n].copy_(torch.where(tt, B1 * mu[n] + (1 - B1) * g, mu[n]))
                nu[n].copy_(torch.where(tt, B2 * nu[n] + (1 - B2) * g * g, nu[n]))
                delta = (mu[n] / bc1.view(shape)) / (torch.sqrt(nu[n] / bc2.view(shape)) + EPS)
                t.sub_(seg_lr.view(shape) * touch.view(shape) * delta)
        losses.append(float(loss.detach()))
    return _result(losses, mu, allv)
