"""What the ranks of tests/test_torch_shard.py's worlds run.

Each function runs in a child process of
``photon_tpu_torch.parallel.dryrun.spawn_world`` (a gloo world on the CPU)
and returns numpy arrays and numbers.  Nothing here imports JAX, so the
children start fast; the scenes arrive as the port's objects.
"""
import numpy as np
import torch

from photon_tpu_torch.models import render_fast
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.parallel.shard import make_mesh, scaling_report


def field_gradient(scene, vol, mesh=None, device="cpu"):
    """``(loss, d_field)`` of mean(img^2) through the fast renderer."""
    field = vol.field.detach().clone().requires_grad_(True)
    img = render_image_fast(*scene, vol=vol._replace(field=field), mesh=mesh,
                            device=device)
    loss = torch.mean(img ** 2)
    (g,) = torch.autograd.grad(loss, field)
    return float(loss.detach()), g.numpy()


def world_of_four(device, general, odd):
    """(b) the general scene with its volume; (c) a particle count that no
    world size divides, rendered in chunks of 3 on each rank."""
    mesh = make_mesh(device=device)
    scene, vol = general
    img_b = render_image_fast(*scene, vol=vol, mesh=mesh)
    own_b = render_image_fast(*scene, vol=vol, mesh=mesh, _mesh_reduce=False)
    scene_c, vol_c = odd
    img_c = render_image_fast(*scene_c, vol=vol_c, mesh=mesh,
                              particles_per_chunk=3)
    return dict(img_b=img_b.numpy(), own_b=own_b.numpy(),
                img_c=img_c.numpy(), coord=mesh.get_local_rank())


def world_of_two(device, general, alg3, noisy, slab, noise_seed):
    """(d) the field's gradient; (e) algorithm 3 with the substeps chosen
    from the data; (f) position noise; (g) the 288 x 288 x 6 slab; (i) the
    scaling harness."""
    mesh = make_mesh(device=device)
    out = {}
    out["loss_d"], out["grad_d"] = field_gradient(*general, mesh=mesh)

    # every rank must probe the whole source, so that all choose alike
    probed = []
    real_choose = render_fast.choose_substeps

    def choose(vol, *chief, **kw):
        probed.append(int(chief[0].shape[0]))
        return real_choose(vol, *chief, **kw)

    render_fast.choose_substeps = choose
    render_fast._substep_cache.clear()
    try:
        scene, vol = alg3
        out["img_e"] = render_image_fast(*scene, vol=vol, mesh=mesh,
                                         algorithm=3).numpy()
    finally:
        render_fast.choose_substeps = real_choose
    out["probed_e"] = probed
    out["substeps_e"] = list(render_fast._substep_cache.values())

    normals = []
    real_normals = render_fast._chunk_normals

    def keep(gen, n, r):
        normals.append(real_normals(gen, n, r))
        return normals[-1]

    render_fast._chunk_normals = keep
    try:
        out["img_f"] = render_image_fast(*noisy, mesh=mesh,
                                         noise_seed=noise_seed).numpy()
    finally:
        render_fast._chunk_normals = real_normals
    out["normals_f"] = [a.numpy() for a in normals]

    scene, vol = slab
    out["img_g"] = render_image_fast(*scene, vol=vol, mesh=mesh).numpy()

    out["report_i"] = scaling_report(device_counts=(1, 2), dots_per_device=8,
                                     rays_per_dot=8, sensor=64, reps=1,
                                     device=device)
    return out
