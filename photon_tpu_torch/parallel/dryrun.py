"""The multi-device dry run, and the worlds it runs in.

Counterpart of ``__graft_entry__.dryrun_multichip``: one training step of
the differentiable BOS inversion with the particles sharded over a world of
processes (the exact renderer's differentiable RK4 march on each rank's
share, the image summed over the ranks, the replicated field's gradient
summed by the backward pass, one SGD update), then the sharded fast
renderer on a small volume and on one whose slab exceeds 256 x 256 voxels.

    python -m photon_tpu_torch.parallel.dryrun N            # N cards, NCCL
    python -m photon_tpu_torch.parallel.dryrun N --device cpu   # gloo

:func:`spawn_world` starts the processes (``torch.multiprocessing``, a
``FileStore`` in a temporary directory).  Nothing here imports JAX, so the
children start fast.
"""
from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from photon_tpu_torch.device import DeviceLike, resolve_device
from photon_tpu_torch.parallel.shard import (TIMEOUT, make_mesh, mesh_place,
                                             replicated, shard_bounds,
                                             sum_over)


def _rank_main(rank, n, tmp, card, fn, args):
    """A child of :func:`spawn_world`: join the world, run ``fn``, write
    its result."""
    if card == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
        # the ranks share the host's cores, as under torchrun
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    else:
        dev = torch.device("cuda", rank if card is None else card)
        torch.cuda.set_device(dev)
        # NCCL takes one rank a card; ranks that share one talk gloo
        backend = "nccl" if card is None else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(tmp, "store"), n), rank=rank, world_size=n,
        timeout=TIMEOUT)
    try:
        out = fn(dev, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, n: int, *args, device: DeviceLike = None) -> list:
    """Run ``fn(device, *args)`` on each rank of a new world of ``n``
    processes; return what each rank's call returned (host data: numpy
    arrays, numbers), in rank order.

    ``device=None``: one card a rank (rank r on ``cuda:r``), NCCL; fewer
    cards than ``n`` raises.  ``device="cpu"``: a gloo world on the CPU.  A
    named card (``"cuda:0"``): every rank on that card, gloo, for a machine
    with one card.  A rank that raises fails the call.
    """
    if device is None:
        resolve_device(None)                  # raises without a card
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"a world of {n} processes needs {n} cards, and "
                f"{torch.cuda.device_count()} are visible; pass "
                "device='cpu' for a gloo world on the CPU")
        card = None
    else:
        dev = resolve_device(device)
        card = "cpu" if dev.type == "cpu" else dev.index
    with tempfile.TemporaryDirectory(prefix="photon_world_") as tmp:
        mp.spawn(_rank_main, args=(n, tmp, card, fn, args), nprocs=n,
                 join=True)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def tiny_bos_scene(n_dots=16, rays_per_dot=32, sensor=64):
    """A miniature BOS scene (dot pattern + single-lens camera): the JAX
    dry run's ``_tiny_bos_scene``, its lens samples from a seeded torch
    generator."""
    from photon_tpu_torch.config import default_config
    from photon_tpu_torch.models.optics import camera_setup
    from photon_tpu_torch.models.scenes import bos_source
    from photon_tpu_torch.utils.rng import lens_samples

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = sensor
    cfg.camera_design.y_pixel_number = sensor
    cfg.bos_pattern.grid_point_number = n_dots
    cfg.bos_pattern.particle_number_per_grid_point = 4
    cfg.bos_pattern.lightray_number_per_particle = rays_per_dot
    # shrink the dot field to what the reduced sensor images
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.8 * sensor * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
    cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
    setup = camera_setup(cfg)
    source, _, _ = bos_source(cfg, setup, np.random.default_rng(0))
    r1, r2 = lens_samples(torch.Generator().manual_seed(0), rays_per_dot)
    return cfg, setup, source, r1.numpy(), r2.numpy()


def _ramp_volume(setup, n_xy, n_z, half_width, dev):
    """A ramp of rho along x between the dot plane and the lens (NRRD-frame
    z: the dot plane sits at z = object_distance)."""
    from photon_tpu_torch.volume import build_density_volume

    x = np.linspace(-half_width, half_width, n_xy)
    z = np.linspace(setup.object_distance - 6e5,
                    setup.object_distance - 1e5, n_z)
    rho = 1.225 + 2.0 * (x[:, None, None] - x.min()) / (x.max() - x.min()) \
        * np.ones((1, n_xy, n_z))
    return build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]],
        device=dev)


def dryrun_rank(device, n_devices: int) -> dict:
    """One rank's dry run in the current world (a world of this process
    alone if there is none), on the scene of ``n_devices`` devices.

    Returns the step's loss, the updated field's sum and the two fast
    renders' image sums; raises if one is not finite, or if the large
    volume did not take the march kernel's large tier (on the card).
    """
    from photon_tpu_torch.device import as_f32
    from photon_tpu_torch.models.render import (RenderParams,
                                                _chunk_tensors, trace_chunk)
    from photon_tpu_torch.models.render_fast import render_image_fast
    from photon_tpu_torch.ops.march import march_rays
    from photon_tpu_torch.ops.march_dense_fused import (large_slab,
                                                        march_chief_fused)

    mesh = make_mesh(device=device)
    rank, size, dev = mesh_place(mesh)
    cfg, setup, source, r1, r2 = tiny_bos_scene(
        n_dots=n_devices * 2, rays_per_dot=8, sensor=32)
    cfg.density_gradients.simulate_density_gradients = True
    params = RenderParams.from_setup(cfg, setup, source)
    vol = _ramp_volume(setup, 8, 8, 1e5, dev)

    # the training step: the rank's particles, the field replicated
    lo, hi = shard_bounds(source.num_particles, rank, size)
    chunk = _chunk_tensors(source, slice(lo, hi), dev) \
        + (as_f32(r1, dev), as_f32(r2, dev))
    field = vol.field.reshape(-1, 4).detach().clone().requires_grad_(True)
    field_r = replicated(mesh, field)

    def march_fn(rays):
        return march_rays(vol, rays, algorithm=2, differentiable=True,
                          num_steps=24, field_flat=field_r)

    image = trace_chunk(chunk, params, setup.elements, march_fn,
                        setup.rotation_matrix, setup.inverse_rotation_matrix,
                        {})
    image = sum_over(mesh, image)
    loss = torch.mean(image ** 2)             # against a zero target
    (g,) = torch.autograd.grad(loss, field)
    new_field = field.detach() - 1e-3 * g
    if not (torch.isfinite(loss) and torch.isfinite(new_field).all()):
        raise RuntimeError("dry run: the step's loss or field is not finite")

    # the production renderer under the same mesh, on the small volume and
    # on a slab of 288 x 288 voxels (the JAX package's windowed march; here
    # the march kernel's large tier)
    img = render_image_fast(cfg, setup, source, r1, r2, vol=vol, mesh=mesh)
    vol_w = _ramp_volume(setup, 288, 6, 1.5e5, dev)
    if not large_slab(288, 288):
        raise RuntimeError("dry run: a 288 x 288 slab is not on the large "
                           "tier")
    before = march_chief_fused.launches_large
    img_w = render_image_fast(cfg, setup, source, r1, r2, vol=vol_w,
                              mesh=mesh)
    if dev.type == "cuda" and march_chief_fused.launches_large == before:
        raise RuntimeError("dry run: the large volume did not launch the "
                           "march kernel's large tier")
    out = dict(loss=float(loss.detach()),
               field_sum=float(new_field.sum()),
               fast_img_sum=float(img.sum()),
               windowed_img_sum=float(img_w.sum()))
    for k, v in out.items():
        if not np.isfinite(v):
            raise RuntimeError(f"dry run: {k} is not finite")
    return out


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """The dry run over a new world of ``n_devices`` processes: one card
    each (NCCL; fewer cards raises), or gloo on the CPU with
    ``device="cpu"``.  Prints one line and returns rank 0's readings;
    every rank must read alike."""
    results = spawn_world(dryrun_rank, n_devices, n_devices, device=device)
    r0 = results[0]
    for r, res in enumerate(results[1:], 1):
        if res != r0:
            raise RuntimeError(f"dry run: rank {r} read {res}, rank 0 {r0}")
    print(f"dryrun_multichip({n_devices}): loss={r0['loss']:.6g} "
          f"fast_img_sum={r0['fast_img_sum']:.6g} "
          f"windowed_img_sum={r0['windowed_img_sum']:.6g} ok")
    return r0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None,
                    help="cpu: a gloo world on the CPU (default: a card a "
                    "process, NCCL)")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, device=a.device)
