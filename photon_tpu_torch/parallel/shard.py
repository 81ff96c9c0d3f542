"""Multi-device execution: the particles split over the processes of a
``torch.distributed`` world, one process a device.

Counterpart of ``photon_tpu/parallel/shard.py``.  The reference is one GPU
and one process; the JAX package shards the particle batch over a
``jax.sharding.Mesh`` with ``shard_map``.  Here:

* a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the world's first
  ``n`` ranks (``make_mesh``), one process a device (``multihost_init``
  joins the processes of one or many hosts);
* every rank receives the whole source and renders its contiguous share of
  the particles through the single-device kernels
  (``models.render_fast.render_image_fast(mesh=...)``), the density volume
  and the optics replicated;
* one all-reduce sums the ranks' full-size images (:func:`sum_over`), and
  the gradient with respect to the replicated field is summed by the same
  all-reduce in the backward pass (:func:`replicated`): JAX's ``psum`` and
  its transpose.

``python -m photon_tpu_torch.parallel.shard`` runs the scaling harness
(:func:`scaling_report`) under ``torchrun``:

    torchrun --nproc-per-node N -m photon_tpu_torch.parallel.shard

NCCL across the node's cards; ``--device cpu`` runs gloo on the CPU.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import statistics
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from photon_tpu_torch.device import DeviceLike, resolve_device

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(dev: torch.device) -> str:
    """NCCL between cards; gloo only for a world on the CPU."""
    return "nccl" if dev.type == "cuda" else "gloo"


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: DeviceLike = None) -> None:
    """Join this process to a world of ``num_processes`` (no-op for one).

    ``coordinator_address``: ``host:port`` of rank 0, which hosts the
    rendezvous store.  On the card (``device=None``) the process takes card
    ``process_id % torch.cuda.device_count()`` and the world talks NCCL;
    ``device="cpu"`` joins a gloo world on the CPU.  After it returns,
    ``make_mesh()`` spans the world.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several processes needs the "
                         "coordinator's address and this process's id")
    if device is None:
        resolve_device(None)                  # raises without a card
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dev = resolve_device(device)
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "particles",
              device: DeviceLike = None) -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` ranks of the world (all by
    default).

    Without a world it starts one of this process alone, on an in-process
    store (no network).  ``device``: the rank's device (None: its card).
    Every rank of the world calls it, since a mesh over part of the world
    makes a new process group; a rank outside the mesh renders nothing on
    it.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=TIMEOUT)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "processes (one process a device)")
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis_name,))


def mesh_place(mesh) -> tuple:
    """``(rank in the mesh, mesh size, the rank's device)`` of this process;
    raises for anything but a 1-D DeviceMesh that holds it."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.shard.make_mesh), not "
                        f"{type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(f"the particles shard over a 1-D mesh, not "
                         f"{mesh.ndim}-D")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    dev = torch.device("cpu") if mesh.device_type == "cpu" \
        else resolve_device(None)
    return mesh.get_local_rank(), mesh.size(), dev


def shard_bounds(P: int, rank: int, size: int) -> tuple:
    """The contiguous particles ``[lo, hi)`` that ``rank`` of ``size``
    renders: shares of ``P // size`` or one more, none empty for P >= size.
    """
    return rank * P // size, (rank + 1) * P // size


def pad_to_multiple(arrays, multiple: int, fills=None):
    """Pad each array's leading dim to a multiple of the mesh size.

    ``fills[i]`` is the pad value for array i (default 0).  Returns
    (padded_arrays, original_length).  The port's renderer does not need
    it: its ranks take shares of unequal size.
    """
    n = int(arrays[0].shape[0])
    pad = (-n) % multiple
    if pad == 0:
        return tuple(np.asarray(a) for a in arrays), n
    if fills is None:
        fills = [0.0] * len(arrays)
    out = []
    for a, fill in zip(arrays, fills):
        a = np.asarray(a)
        out.append(np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)]))
    return tuple(out), n


# ---------------------------------------------------------------------------
# The two collectives: JAX's psum and the transpose of a replicated input
# ---------------------------------------------------------------------------


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        # every rank already holds the cotangent of the sum; summing it
        # again (torch.distributed.nn.functional.all_reduce's backward)
        # would scale a loss that every rank computes by the world size
        return grad, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def sum_over(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, on every rank (one
    all-reduce); its backward passes the cotangent through."""
    return _SumOver.apply(x, mesh.get_group())


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """``x``, held alike by every rank; its backward sums the ranks'
    cotangents (one all-reduce)."""
    return _Replicated.apply(x, mesh.get_group())


# ---------------------------------------------------------------------------
# Scaling harness
# ---------------------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scene(n_dots: int, rays_per_dot: int, sensor: int, dev: torch.device):
    """The JAX harness's weak-scaling scene: ``n_dots`` overlapping BOS
    dots of 8 points, a ramp volume of 16^3 between dots and lens."""
    from photon_tpu_torch.config import default_config
    from photon_tpu_torch.models.optics import camera_setup
    from photon_tpu_torch.models.scenes import bos_source
    from photon_tpu_torch.utils.rng import lens_samples
    from photon_tpu_torch.volume import build_density_volume

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = sensor
    cfg.camera_design.y_pixel_number = sensor
    cfg.bos_pattern.grid_point_number = n_dots
    # overlapping placement places every requested dot, so the work per
    # device stays constant (asserted by scaling_report)
    cfg.bos_pattern.dot_overlap = True
    cfg.bos_pattern.particle_number_per_grid_point = 8
    cfg.bos_pattern.lightray_number_per_particle = rays_per_dot
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.8 * sensor * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
    cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(1105))
    r1, r2 = lens_samples(torch.Generator().manual_seed(1105), rays_per_dot)
    n = 16
    x = np.linspace(-1.5e5, 1.5e5, n)
    z = np.linspace(setup.object_distance - 5e5,
                    setup.object_distance - 1e2, n)
    rho = 1.225 + 5.0 * (x[:, None, None] - x.min()) \
        / (x.max() - x.min()) * np.ones((1, n, n))
    vol = build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]],
        device=dev)
    return cfg, setup, src, r1.numpy(), r2.numpy(), vol


def scaling_report(device_counts=(1, 2, 4, 8), dots_per_device: int = 128,
                   rays_per_dot: int = 64, sensor: int = 256,
                   reps: int = 5, device: DeviceLike = None
                   ) -> Optional[dict]:
    """Weak-scaling sweep of the sharded fast renderer (forward, and forward
    with backward), on every rank of the world; the report on rank 0, None
    on the others.

    For each N in ``device_counts`` up to the world size: N *
    ``dots_per_device`` dots sharded over ``make_mesh(N)``, the median of
    ``reps`` host-clock times (device synchronised) of

    * ``weak``: a render; ``weak_scaling_efficiency`` is T(1) / T(N);
    * ``grad``: the gradient of mean(img^2) with respect to the replicated
      field (its backward all-reduces the field's gradient);
    * ``collective``: the same render with and without the image's
      all-reduce (``_mesh_reduce=False``): ``psum_fraction`` is the
      collective's share of the reduced render's time.

    ``caveat`` says whether the ranks had a device each: ranks that share a
    card or the CPU share its compute, and their efficiencies say nothing
    of the sharding.
    """
    from photon_tpu_torch.models.render_fast import render_image_fast

    dev = resolve_device(device)
    if not dist.is_initialized():
        make_mesh(device=dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    places = [None] * world
    dist.all_gather_object(places, f"{socket.gethostname()}/{dev}")
    counts = [n for n in device_counts if n <= world]
    report = {"devices_available": world, "platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "physical_cores": os.cpu_count(), "device_counts": counts,
              "weak": {}, "grad": {}, "collective": {}}

    def timed(fn):
        fn()                                  # kernels loaded, caches warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    rays1 = t1 = g1 = None
    for n in counts:
        cfg, setup, src, r1, r2, vol = _scene(n * dots_per_device,
                                              rays_per_dot, sensor, dev)
        if rays1 is None:
            rays1 = src.num_rays / n
        # weak scaling means something only at constant work per device
        if src.num_rays != n * rays1:
            raise RuntimeError(
                f"weak-scaling invariant violated: n={n} runs "
                f"{src.num_rays} rays, expected {n} * {rays1:.0f}: the "
                "scene generator did not place the requested dots")
        mesh = make_mesh(n, device=dev)       # collective: every rank
        if rank >= n:
            continue

        def fwd(reduce=True):
            render_image_fast(cfg, setup, src, r1, r2, vol=vol, mesh=mesh,
                              _mesh_reduce=reduce)
            _sync(dev)

        def grad_step():
            field = vol.field.detach().clone().requires_grad_(True)
            img = render_image_fast(cfg, setup, src, r1, r2,
                                    vol=vol._replace(field=field), mesh=mesh)
            torch.autograd.grad(torch.mean(img * img), field)
            _sync(dev)

        t_mesh = timed(fwd)
        t_nored = timed(lambda: fwd(reduce=False))
        t_grad = timed(grad_step)
        rays = src.num_rays
        report["weak"][n] = {"time_s": t_mesh, "rays": rays,
                             "rays_per_s": rays / t_mesh}
        report["grad"][n] = {"time_s": t_grad, "rays": rays,
                             "rays_per_s": rays / t_grad}
        report["collective"][n] = {
            "time_reduced_s": t_mesh, "time_unreduced_s": t_nored,
            "psum_fraction": max(0.0, (t_mesh - t_nored) / t_mesh)}
        if t1 is None:
            t1, g1 = t_mesh, t_grad
    if rank != 0:
        return None
    for n in counts:
        report["weak"][n]["weak_scaling_efficiency"] = \
            min(t1 / report["weak"][n]["time_s"], 1.0)
        report["grad"][n]["weak_scaling_efficiency"] = \
            min(g1 / report["grad"][n]["time_s"], 1.0)
    shared = len(set(places)) < world
    if dev.type == "cpu":
        report["caveat"] = (
            "gloo world on the CPU: every rank shares the host's cores, so "
            "weak-scaling efficiency is bound by cores over ranks, not by "
            "the sharding (efficiencies are clamped at 1.0). "
            "collective.psum_fraction compares the same sharded renders with "
            "and without the image's all-reduce; grad.* times forward and "
            "backward, whose backward all-reduces the field's gradient.")
    elif shared:
        report["caveat"] = (
            "ranks share a card: they split one device's compute, so "
            "weak-scaling efficiency says nothing of the sharding; "
            "psum_fraction reads a collective within one card")
    else:
        report["caveat"] = "one card a rank"
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Weak-scaling sweep of the sharded renderer; run under "
        "torchrun, one process a card.")
    ap.add_argument("--device", default=None,
                    help="cpu: a gloo world on the CPU (default: the "
                    "process's card, NCCL)")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        multihost_init(f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}", world,
                       int(os.environ["RANK"]), device=args.device)
    try:
        rep = scaling_report(device=args.device)
        if rep is not None:
            print(json.dumps(rep, indent=2, default=float))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
