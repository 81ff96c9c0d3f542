"""Port vs JAX: rendering across devices (photon_tpu_torch/parallel/).

The port's worlds are gloo worlds of CPU processes spawned by
``parallel.dryrun.spawn_world``; what their ranks run is in
``tests/torch_shard_workers.py`` (no JAX there) and comes back as numpy
arrays.  The JAX side runs here, on the conftest's 8 virtual CPU devices,
as tests/test_sharding.py runs it.  A world of one runs in this process, on
an in-process store.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.render_fast import render_image_fast as jax_render
from photon_tpu.models.scenes import bos_source as jax_bos_source
from photon_tpu.utils.rng import lens_samples as jax_lens_samples
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render_fast import rank_seed, render_image_fast
from photon_tpu_torch.parallel import (make_mesh, multihost_init,
                                       pad_to_multiple)
from photon_tpu_torch.parallel.shard import shard_bounds
from photon_tpu_torch.parallel.dryrun import (dryrun_multichip, dryrun_rank,
                                              spawn_world)
from photon_tpu_torch.volume import build_density_volume
from tests import torch_shard_workers as workers
from tests.test_bos_pipeline import bos_case, gradient_volume_between
from tests.torch_port_helpers import (port_config, port_source, port_volume,
                                      rel_l1)

# test_sharding's bound between the JAX package's mesh and single-device
# renders, and between the port's sharded and single renders here
_L1_MESH = 1e-4
# the port against the JAX package on one device (tests/test_torch_render.py,
# the JAX package's fast-vs-exact budget): this scene reads 1.8e-4 there, the
# thick lens's cancellation on 16 rays a particle
_L1_PORT = 1e-3
# float atomics and the order of the ranks' sum move the port's images by
# ~1e-7 of the sum
_L1_WORLDS = 1e-6
NOISE_SEED = 1234


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _subset(src, n):
    sl = slice(0, n)
    return dataclasses.replace(src, x=src.x[sl], y=src.y[sl], z=src.z[sl],
                               radiance=src.radiance[sl],
                               diameter_index=src.diameter_index[sl])


@pytest.fixture(scope="module")
def general():
    """tests/test_sharding.py's scene: both sides."""
    cfg = bos_case("general", n_dots=6, rays=16)
    setup = jax_camera_setup(cfg)
    src, *_ = jax_bos_source(cfg, setup, np.random.default_rng(11))
    r1, r2 = (np.asarray(r) for r in jax_lens_samples(jax.random.key(5), 16))
    vol, *_ = gradient_volume_between(setup, n=16)
    tcfg = port_config(cfg)
    return dict(jax=(cfg, setup, src, r1, r2), jax_vol=vol,
                torch=(tcfg, camera_setup(tcfg), port_source(src), r1, r2),
                torch_vol=port_volume(vol))


@pytest.fixture(scope="module")
def jax_side(general):
    """JAX's single-device render, its 8-device mesh render and jax.grad of
    mean(img^2) through the mesh render."""
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("particles",))
    jv = general["jax_vol"]
    single = np.asarray(jax_render(*general["jax"], vol=jv))
    img8 = np.asarray(jax_render(*general["jax"], vol=jv, mesh=mesh))
    grad8 = np.asarray(jax.grad(lambda f: jnp.mean(jax_render(
        *general["jax"], vol=jv._replace(field=f), mesh=mesh) ** 2))(
            jv.field))
    return dict(single=single, img8=img8, grad8=grad8)


@pytest.fixture(scope="module")
def world_of_one():
    """A world of this process alone (gloo, in-process store) and its
    mesh."""
    started = not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


def _odd(general):
    """(c): the general scene's first 37 particles: no world size of 2-4
    divides them."""
    tcfg, setup, src, r1, r2 = general["torch"]
    return (tcfg, setup, _subset(src, 37), r1, r2), general["torch_vol"]


def _alg3(general):
    """(e): the general scene and its volume, marched with algorithm 3."""
    return general["torch"], general["torch_vol"]


def _noisy():
    """(f): tests/test_torch_ray_chain.py's variance scene with 2 px of
    position noise; returns (noiseless scene, noisy scene)."""
    cfg = bos_case("apparent", n_dots=6, rays=256)
    cfg.bos_pattern.grid_point_number = 1
    tcfg = port_config(cfg)
    setup = camera_setup(tcfg)
    src = port_source(jax_bos_source(cfg, jax_camera_setup(cfg),
                                     np.random.default_rng(11))[0])
    r1, r2 = (np.asarray(a) for a in jax_lens_samples(jax.random.key(5),
                                                      256))
    noisy = port_config(cfg)
    noisy.density_gradients.add_pos_noise = True
    noisy.density_gradients.pos_noise_std = 2.0
    return (tcfg, setup, src, r1, r2), (noisy, setup, src, r1, r2)


def _slab():
    """(g): tests/test_sharding.py's 288 x 288 x 6 volume and scene."""
    from photon_tpu_torch.config import default_config
    from photon_tpu_torch.models.scenes import bos_source
    from photon_tpu_torch.utils.rng import lens_samples

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 128
    cfg.bos_pattern.grid_point_number = 200
    cfg.bos_pattern.particle_number_per_grid_point = 4
    cfg.bos_pattern.lightray_number_per_particle = 8
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.7 * 128 * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
    cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(3))
    r1, r2 = lens_samples(torch.Generator().manual_seed(7), 8)
    n, d = 288, 6
    x = np.linspace(-2e5, 2e5, n)
    z = np.linspace(setup.object_distance - 0.6 * setup.object_distance,
                    setup.object_distance - 0.1 * setup.object_distance, d)
    gx = np.linspace(0, 1, n)
    rho = 1.225 + 2.0 * gx[:, None, None] * np.ones((1, n, d))
    vol = build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]],
        device="cpu")
    return (cfg, setup, src, r1.numpy(), r2.numpy()), vol


@pytest.fixture(scope="module")
def four(general):
    """A gloo world of four processes: (b) and (c)."""
    scene = (general["torch"], general["torch_vol"])
    return spawn_world(workers.world_of_four, 4, scene, _odd(general),
                       device="cpu")


@pytest.fixture(scope="module")
def two(general):
    """A gloo world of two processes: (d)-(g) and (i)."""
    return spawn_world(workers.world_of_two, 2,
                       (general["torch"], general["torch_vol"]),
                       _alg3(general), _noisy()[1], _slab(), NOISE_SEED,
                       device="cpu")


# ---------------------------------------------------------------------------
# (a) the helpers
# ---------------------------------------------------------------------------

def test_shard_helpers(world_of_one):
    """tests/test_sharding.py::test_shard_helpers through the port:
    multihost_init no-ops for one process, make_mesh spans the world,
    pad_to_multiple pads with the requested fills; a mesh larger than the
    world and a world without a card (no device="cpu") raise."""
    multihost_init()
    multihost_init(num_processes=1)
    mesh = world_of_one
    assert dist.get_world_size() == 1
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("particles",)
    assert mesh.get_local_rank() == 0 and mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost_init("localhost:1", num_processes=2, process_id=0)

    a = np.arange(5, dtype=np.float32)
    (pa, pz), n = pad_to_multiple((a, a), 4, fills=(0.0, 1.0))
    assert n == 5 and pa.shape == (8,)
    assert pa[5:].sum() == 0.0 and (pz[5:] == 1.0).all()
    (same,), n2 = pad_to_multiple((a,), 5)
    assert n2 == 5 and same.shape == (5,)

    # the ranks' shares cover the particles once, none empty
    for P, N in ((90, 4), (37, 3), (5, 4), (4, 4)):
        bounds = [shard_bounds(P, r, N) for r in range(N)]
        assert bounds[0][0] == 0 and bounds[-1][1] == P
        assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
        assert all(hi > lo for lo, hi in bounds)


def test_world_of_one_renders_as_no_mesh(general, world_of_one):
    """A mesh of one renders the image without a mesh bit for bit, and
    with fewer particles than ranks the mesh refuses."""
    kw = dict(vol=general["torch_vol"])
    plain = render_image_fast(*general["torch"], device="cpu", **kw)
    one = render_image_fast(*general["torch"], mesh=world_of_one, **kw)
    assert torch.equal(plain, one) and float(one.sum()) > 0
    own = render_image_fast(*general["torch"], mesh=world_of_one,
                            _mesh_reduce=False, **kw)
    assert own.shape == (1,) + plain.shape and torch.equal(own[0], plain)
    with pytest.raises(ValueError, match="device"):
        render_image_fast(*general["torch"], mesh=world_of_one,
                          device="meta", **kw)


# ---------------------------------------------------------------------------
# (b), (c) the image in a world of four
# ---------------------------------------------------------------------------

def test_sharded_image_matches_jax_mesh(general, jax_side, four,
                                        world_of_one):
    """A world of four against JAX's 8-device mesh render and its
    single-device render: within the port's budget against JAX (1e-3), and
    as far from them as the port's single render is from JAX's, to 1e-6 of
    the sum (the sharding adds nothing to what separates the packages;
    JAX's mesh and single renders sit 1e-8 apart); against the port's world
    of one, 1e-6 of the sum."""
    img4 = four[0]["img_b"]
    for r in four[1:]:
        np.testing.assert_array_equal(r["img_b"], img4)
    assert [r["coord"] for r in four] == [0, 1, 2, 3]
    one = render_image_fast(*general["torch"], vol=general["torch_vol"],
                            mesh=world_of_one).numpy()
    l1_8 = rel_l1(img4, jax_side["img8"])
    l1_1 = rel_l1(img4, jax_side["single"])
    l1_ports = rel_l1(one, jax_side["single"])
    l1_port = rel_l1(img4, one)
    print(f"world of four: L1 {l1_8:.3g} against JAX's mesh of 8, "
          f"{l1_1:.3g} against its single device ({l1_ports:.3g} from the "
          f"port's world of one), {l1_port:.3g} against the port's world of "
          f"one")
    assert img4.sum() > 0
    np.testing.assert_allclose(img4.sum(), jax_side["img8"].sum(), rtol=1e-4)
    assert rel_l1(jax_side["img8"], jax_side["single"]) < _L1_MESH
    assert l1_8 < _L1_PORT and l1_1 < _L1_PORT
    assert abs(l1_8 - l1_ports) < _L1_WORLDS
    assert abs(l1_1 - l1_ports) < _L1_WORLDS
    assert l1_port < _L1_WORLDS
    # the ranks' own images are shares of it: no rank rendered it all
    owns = np.concatenate([r["own_b"] for r in four])
    assert owns.shape == (4,) + img4.shape
    assert all(o.sum() < 0.5 * img4.sum() for o in owns)
    assert rel_l1(owns.sum(0), img4) < _L1_WORLDS


def test_particle_count_no_world_size_divides(general, four):
    """37 particles over four ranks (9, 9, 9, 10), in chunks of 3 on each:
    the render without a mesh, to 1e-6 of the sum."""
    scene, vol = _odd(general)
    assert scene[2].num_particles == 37
    ref = render_image_fast(*scene, vol=vol, device="cpu").numpy()
    img = four[0]["img_c"]
    l1 = rel_l1(img, ref)
    print(f"37 particles over four ranks: L1 {l1:.3g}")
    assert ref.sum() > 0 and l1 < _L1_WORLDS


# ---------------------------------------------------------------------------
# (d)-(g), (i) a world of two
# ---------------------------------------------------------------------------

def test_field_gradient_matches_jax_mesh(general, jax_side, two,
                                         world_of_one):
    """d mean(img^2) / d field in a world of two against jax.grad through
    JAX's mesh render (cosine >= 0.9999, as test_torch_inverse holds the
    single device, and a relative L2 well under the 1.0 that a gradient
    scaled by the world size would read) and against the port's world of
    one (1e-5 of its largest value)."""
    g2 = two[0]["grad_d"]
    np.testing.assert_array_equal(two[1]["grad_d"], g2)
    loss1, g1 = workers.field_gradient(general["torch"], general["torch_vol"],
                                       mesh=world_of_one)
    ref = jax_side["grad8"]
    cos = _cosine(g2, ref)
    rel = float(np.linalg.norm(g2 - ref) / np.linalg.norm(ref))
    rel1 = float(np.abs(g2 - g1).max() / np.abs(g1).max())
    print(f"world of two d_field: cosine {cos:.7f} and relative L2 "
          f"{rel:.3g} against JAX's mesh, {rel1:.3g} of the maximum from "
          f"the world of one; norms {np.linalg.norm(g2):.4g} / "
          f"{np.linalg.norm(ref):.4g}")
    assert np.isfinite(g2).all() and np.abs(ref).max() > 0
    assert cos >= 0.9999 and rel < 0.05
    assert rel1 < 1e-5
    assert two[0]["loss_d"] == pytest.approx(loss1, rel=1e-6)


def test_substeps_chosen_from_the_whole_source(general, two):
    """Algorithm 3 without march_substeps: every rank probes all 90 chief
    rays and chooses the same count; the image is the unsharded one."""
    for r in two:
        assert r["probed_e"] == [90]
        assert r["substeps_e"] == two[0]["substeps_e"]
    assert len(two[0]["substeps_e"]) == 1
    scene, vol = _alg3(general)
    ref = render_image_fast(*scene, vol=vol, algorithm=3,
                            march_substeps=two[0]["substeps_e"][0],
                            device="cpu").numpy()
    l1 = rel_l1(two[0]["img_e"], ref)
    print(f"algorithm 3, substeps {two[0]['substeps_e']}: L1 {l1:.3g}")
    assert l1 < _L1_WORLDS


def test_noise_streams_per_rank(two):
    """Rank 0 draws the unsharded render's stream, rank 1 one of its own;
    the sharded noisy spot grows its second moment by std^2 within 25% and
    keeps its sum to 5% (tests/test_torch_ray_chain.py's bounds)."""
    base_scene, noisy_scene = _noisy()
    P, R = noisy_scene[2].num_particles, len(noisy_scene[3])
    (lo0, hi0), (lo1, hi1) = (shard_bounds(P, r, 2) for r in range(2))
    n0, n1 = two[0]["normals_f"], two[1]["normals_f"]
    assert [a.shape for a in n0] == [(2, hi0 - lo0, R)]
    assert [a.shape for a in n1] == [(2, hi1 - lo1, R)]
    gen = torch.Generator().manual_seed(NOISE_SEED)
    np.testing.assert_array_equal(
        n0[0], torch.randn((2, hi0 - lo0, R), generator=gen).numpy())
    gen = torch.Generator().manual_seed(NOISE_SEED)
    same = torch.randn((2, hi1 - lo1, R), generator=gen).numpy()
    assert not np.allclose(n1[0], same)
    assert rank_seed(NOISE_SEED, 0) == NOISE_SEED
    assert rank_seed(NOISE_SEED, 1) != rank_seed(NOISE_SEED, 2)

    def second_moment(im):
        ys, xs = np.mgrid[0:im.shape[0], 0:im.shape[1]]
        w = im / im.sum()
        cx, cy = (w * xs).sum(), (w * ys).sum()
        return ((w * ((xs - cx) ** 2 + (ys - cy) ** 2)).sum()) / 2.0

    base = render_image_fast(*base_scene, device="cpu").numpy()
    noisy = two[0]["img_f"]
    np.testing.assert_array_equal(two[1]["img_f"], noisy)
    dvar = second_moment(noisy) - second_moment(base)
    print(f"second moment grew by {dvar:.4g} px^2 (std^2 = 4)")
    assert dvar == pytest.approx(4.0, rel=0.25), dvar
    np.testing.assert_allclose(noisy.sum(), base.sum(), rtol=0.05)


def test_sharded_slab_matches_single_render(two):
    """tests/test_sharding.py::test_sharded_windowed_march_matches_single_device
    through the port: a 288 x 288 x 6 slab (the march's large tier) in a
    world of two against the render without a mesh, L1 < 1e-4 (read: 0,
    the plain versions' sums of two shares in order)."""
    scene, vol = _slab()
    ref = render_image_fast(*scene, vol=vol, device="cpu").numpy()
    l1 = rel_l1(two[0]["img_g"], ref)
    print(f"288 x 288 x 6 slab over two ranks: L1 {l1:.3g}")
    assert ref.sum() > 0 and l1 < _L1_MESH


def test_scaling_report_in_a_world_of_two(two):
    """tests/test_sharding.py::test_scaling_report_smoke through the port:
    the report on rank 0 only, with its keys and bounds."""
    rep = two[0]["report_i"]
    assert two[1]["report_i"] is None
    assert rep["device_counts"] == [1, 2] and rep["platform"] == "cpu"
    assert rep["devices_available"] == 2
    assert rep["weak"][2]["rays_per_s"] > 0
    assert rep["grad"][2]["rays_per_s"] > 0
    assert rep["grad"][2]["weak_scaling_efficiency"] <= 1.0
    assert 0.0 <= rep["collective"][2]["psum_fraction"] < 1.0
    assert "CPU" in rep["caveat"]


# ---------------------------------------------------------------------------
# (h) the dry run
# ---------------------------------------------------------------------------

def test_dryrun_multichip(world_of_one, capsys):
    """dryrun_multichip(2) in a gloo world on the CPU: finite, the world of
    one's loss on the same scene to 1e-6; without a card and without
    device="cpu" it raises instead of falling back to the CPU."""
    two_ranks = dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): loss=" in capsys.readouterr().out
    one = dryrun_rank("cpu", 2)
    print(f"dry run: world of two {two_ranks}, world of one {one}")
    assert np.isfinite(two_ranks["loss"]) and two_ranks["loss"] > 0
    assert two_ranks["loss"] == pytest.approx(one["loss"], rel=1e-6)
    for k in ("field_sum", "fast_img_sum", "windowed_img_sum"):
        assert two_ranks[k] == pytest.approx(one[k], rel=1e-6), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multichip(2)
