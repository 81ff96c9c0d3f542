"""Port vs JAX: the ray dumps (``pipeline._save_lightrays``), their analysis
(``analysis/light_rays.py``, ``analysis/fields.py``) and
``utils/profiling.ray_statistics``, on the CPU, on the same seeded inputs.

``run_bos`` with ``save_lightrays`` writes the JAX package's files (names,
sizes, rays within the exact march's 0.1 um and 1e-6); its chunked trace
equals one trace of the whole source; the intermediate dumps match the JAX
package's (the same NaN pattern, finite values at the same tolerances);
the analysis functions return the JAX package's numbers (numpy either side:
equal, or within 1e-6 where the oracle samples the volume in float32); and
the reference's C18 flow (tests/test_bos_pipeline.py:194-235) runs through
the port at that test's rtol 0.10.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import photon_tpu.analysis.fields as jfields
import photon_tpu.analysis.light_rays as jlight
from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.scenes import bos_source as jax_bos_source
from photon_tpu.ops.lens import RayBundle as JaxBundle
from photon_tpu.pipeline import run_bos as jax_run_bos
from photon_tpu.utils.profiling import ray_statistics as jax_ray_statistics
from photon_tpu_torch import pipeline
from photon_tpu_torch.analysis import fields, light_rays
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render import render_rays
from photon_tpu_torch.models.scenes import bos_source
from photon_tpu_torch.ops.lens import RayBundle
from photon_tpu_torch.ops.march import make_march_fn
from photon_tpu_torch.utils.nrrd_io import write_nrrd
from photon_tpu_torch.utils.profiling import ray_statistics
from tests.test_bos_pipeline import bos_case, gradient_volume_between
from tests.torch_port_helpers import port_config, port_source, port_volume

POS_ATOL, DIR_ATOL = 0.1, 1e-6          # tests/test_torch_exact_march.py


def _dump_case(d, algorithm=2, per_chunk=5):
    """A small BOS case (4 dots, 16 rays a particle) whose volume bends
    the rays between the dot plane and the lens, with a ray budget of
    ``per_chunk`` particles, so the dumps span several files."""
    cfg = bos_case("general", n_dots=4, rays=16)
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
    cfg.reference_lens_rng = True
    setup = jax_camera_setup(cfg)
    n, extent = 12, 4e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z = np.linspace(0.4 * setup.object_distance,
                    0.9 * setup.object_distance, n)
    rho = 1.225 + 4.0 * (x[:, None, None] - x.min()) / (x.max() - x.min()) \
        * np.ones((1, n, n))
    nrrd = str(d / "rho.nrrd")
    write_nrrd(nrrd, rho.astype(np.float32),
               spacings=(x[1] - x[0], x[1] - x[0], z[1] - z[0]),
               space_origin=(x[0], x[0], z[0]))
    cfg.density_gradients.simulate_density_gradients = True
    cfg.density_gradients.density_gradient_filename = nrrd
    cfg.density_gradients.ray_tracing_algorithm = algorithm
    cfg.bos_pattern.lightray_process_number = per_chunk * 16
    cfg.output_data.save_lightrays = True
    return cfg


def _run_both(d, cfg):
    """run_bos of both packages into d/jax and d/port; returns the two
    results and the dumps' paths relative to each directory."""
    import copy
    out = []
    for side in ("jax", "port"):
        c = copy.deepcopy(cfg)
        c.output_data.image_directory = str(d / side)
        if side == "jax":
            res = jax_run_bos(c, rng=np.random.default_rng(11))
        else:
            res = pipeline.run_bos(port_config(c),
                                   rng=np.random.default_rng(11),
                                   device="cpu")
        files = sorted(p.relative_to(d / side)
                       for p in (d / side).rglob("*.bin"))
        out.append((res, files))
    return out


def _hold_dump(a, b, name):
    atol = DIR_ATOL if "dir" in name else POS_ATOL
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("n_save", [0, 200])
def test_run_bos_writes_the_jax_packages_files(tmp_path, n_save):
    """All rays (0), and 200 rays, which end inside the third chunk of 80
    and inside a particle: the same names and sizes as the JAX package's
    files, the rays within the march's tolerance, for im1 and im2."""
    cfg = _dump_case(tmp_path)
    cfg.output_data.num_lightrays_save = n_save
    (_, jfiles), (got, tfiles) = _run_both(tmp_path, cfg)
    assert tfiles == jfiles
    n_rays = n_save or got.sources["bos"].num_rays
    assert len(jfiles) == 4 * -(-n_rays // 80) > 4
    total = 0
    for rel in jfiles:
        assert os.path.getsize(tmp_path / "port" / rel) == os.path.getsize(
            tmp_path / "jax" / rel)
        a = np.fromfile(tmp_path / "port" / rel, np.float32).reshape(-1, 3)
        b = np.fromfile(tmp_path / "jax" / rel, np.float32).reshape(-1, 3)
        _hold_dump(a, b, str(rel))
        total += a.shape[0]
    assert total == 4 * n_rays
    assert got.timer.phases["save_lightrays"] > 0


def test_chunked_dump_equals_one_whole_source_trace(tmp_path):
    """The chunked trace of the saved particles writes what one
    render_rays over the whole source gives, bit for bit."""
    cfg = port_config(_dump_case(tmp_path))
    cfg.output_data.num_lightrays_save = 0
    cfg.output_data.image_directory = str(tmp_path / "out")
    res = pipeline.run_bos(cfg, rng=np.random.default_rng(11), device="cpu")
    src = res.sources["bos"]
    vol = pipeline._load_volume(cfg, torch.device("cpu"))
    r1, r2 = pipeline._lens_sample_pair(cfg, src.lightray_number_per_particle)
    for tag, march_fn in (("im1", None), ("im2", make_march_fn(vol))):
        whole = render_rays(cfg, res.setup, src, r1, r2, march_fn=march_fn,
                            device="cpu")
        for kind, ref in (("positions", whole.pos), ("directions",
                                                     whole.dir)):
            got = light_rays.load_ray_data(
                str(tmp_path / "out" / f"light-ray-{kind}" / tag),
                "pos" if kind == "positions" else "dir")
            np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("algorithm", [2, 4])
def test_intermediate_dumps_match_jax(tmp_path, algorithm):
    """save_intermediate_ray_data with RK4 and Adams-Bashforth: 40 rays (two
    and a half particles, over two chunks of 32) for 24 iterations, against
    the JAX package's: the same NaN pattern, finite values at the march's
    tolerance, beside the final dumps.  (RK45's recording is held against
    the JAX package run op by op in tests/test_torch_exact_menu.py: the
    jitted run flips.)"""
    cfg = _dump_case(tmp_path, algorithm=algorithm, per_chunk=2)
    cfg.output_data.num_lightrays_save = 40
    cfg.output_data.save_intermediate_ray_data = True
    cfg.output_data.num_intermediate_positions_save = 24
    (_, jfiles), (_, tfiles) = _run_both(tmp_path, cfg)
    assert tfiles == jfiles
    inter = [f for f in jfiles if f.name.startswith("intermediate")]
    assert len(inter) == 2 and all("im2" in str(f) for f in inter)
    for rel in jfiles:
        a = np.fromfile(tmp_path / "port" / rel, np.float32)
        b = np.fromfile(tmp_path / "jax" / rel, np.float32)
        _hold_dump(a, b, str(rel))
    for prefix in ("intermediate_pos", "intermediate_dir"):
        d = "positions" if prefix.endswith("pos") else "directions"
        traj = light_rays.load_intermediate_ray_data(
            str(tmp_path / "port" / f"light-ray-{d}" / "im2"), 24, prefix)
        assert traj.shape == (40, 24, 3)
        assert np.isfinite(traj[:, :3]).all()


# ---------------------------------------------------------------------------
# analysis/ function by function
# ---------------------------------------------------------------------------

def _nan_rays(n=600, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0.0, 2e3, (n, 3)).astype(np.float32)
    pos[rng.random(n) < 0.2] = np.nan
    return pos


_CASES = {
    "positions_to_pixels": lambda m: m.positions_to_pixels(
        _nan_rays(), 17.0, 128, 96),
    "positions_to_pixels_unmirrored": lambda m: m.positions_to_pixels(
        _nan_rays(), 17.0, 128, 96, mirror_x=False),
    "dot_averaged_positions": lambda m: m.dot_averaged_positions(
        _nan_rays(), 20),
    "ray_deflections": lambda m: m.ray_deflections(
        _nan_rays(seed=1), _nan_rays(seed=2), _nan_rays(seed=3),
        _nan_rays(seed=4)),
    "remove_edge_dots": lambda m: m.remove_edge_dots(
        np.abs(_nan_rays(30)[:, :2]) / 30.0, np.arange(30.0), 128, 96),
    "interpolate_to_grid": lambda m: m.interpolate_to_grid(
        np.random.default_rng(5).uniform(0, 50, (40, 2)),
        np.random.default_rng(6).normal(size=40), np.linspace(5, 45, 9),
        np.linspace(5, 45, 7)),
    "process_lightray_data": lambda m: m.process_lightray_data(
        _nan_rays(seed=7), _nan_rays(seed=8), 30, 17.0, 128, 96),
    "create_coordinate_grid": lambda m: m.create_coordinate_grid(11),
    "create_sine_field": lambda m: m.create_sine_field(13, 2.0, 0.3),
    "create_sine_field_3d": lambda m: m.create_sine_field_3d(9, 2.0, 0.3),
    "create_gaussian_field": lambda m: m.create_gaussian_field(
        13, 1.5, (0.1, -0.2), 0.2),
    "theoretical_deflection": lambda m: m.theoretical_deflection(
        4.0 / 4e5, 0.12, 4e5, 2e5, 1.3, 17.0),
    "density_gradient_for_displacement": lambda m:
        m.density_gradient_for_displacement(0.5, 0.12, 4e5, 2e5, 1.3, 17.0),
    "density_noise_for_displacement_noise": lambda m:
        m.density_noise_for_displacement_noise(0.1, 0.12, 4e5, 5e3, 2e5,
                                               1.3, 17.0),
}


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(_CASES))
def test_analysis_function_matches_jax(name):
    """Each analysis function on the same numpy inputs: equal results."""
    fn = _CASES[name]
    pair = (light_rays, jlight) if name.startswith(
        ("positions", "dot_", "ray_", "remove", "interp", "process")) \
        else (fields, jfields)
    _equal(fn(pair[0]), fn(pair[1]))


def test_ray_data_files_round_trip_as_jax(tmp_path):
    """save_ray_data / load_ray_data / load_intermediate_ray_data write and
    read the JAX package's bytes; the loaders skip the intermediate dumps
    beside the final ones."""
    pos, dirs = _nan_rays(seed=1), _nan_rays(seed=2)
    paths = [m.save_ray_data(str(tmp_path / tag), pos, dirs, chunk_index=3)
             for tag, m in (("port", light_rays), ("jax", jlight))]
    for p, q in zip(*paths):
        assert open(p, "rb").read() == open(q, "rb").read()
    traj = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    traj.tofile(tmp_path / "port" / "intermediate_pos_0000.bin")
    for m in (light_rays, jlight):
        np.testing.assert_array_equal(
            m.load_ray_data(str(tmp_path / "port")), pos)
        np.testing.assert_array_equal(
            m.load_intermediate_ray_data(str(tmp_path / "port"), 5), traj)
    with pytest.raises(FileNotFoundError):
        light_rays.load_ray_data(str(tmp_path / "port"), "none")


def test_save_density_nrrd_writes_the_jax_packages_bytes(tmp_path):
    """The same header fields and data bytes; only the header's comment
    names the writing package."""
    x = np.linspace(-1.0, 1.0, 5)
    y = np.linspace(0.0, 2.0, 4)
    z = np.linspace(3.0, 4.0, 3)
    rho = np.random.default_rng(0).normal(1.2, 0.1, (5, 4, 3))
    fields.save_density_nrrd(str(tmp_path / "a.nrrd"), rho, x, y, z)
    jfields.save_density_nrrd(str(tmp_path / "b.nrrd"), rho, x, y, z)
    a, b = ((tmp_path / f).read_bytes().split(b"\n", 2)
            for f in ("a.nrrd", "b.nrrd"))
    assert a[0] == b[0] and a[2] == b[2]
    assert a[1].startswith(b"#") and b[1].startswith(b"#")


def test_paraxial_oracle_matches_jax():
    """tests/test_bos_pipeline.py:69-104's case: the per-dot oracle through
    the port's trilinear sampler against the JAX package's (float32 samples
    of the same field, summed alike: within 1e-6 of the largest predicted
    displacement), and the closed form that test holds it to."""
    cfg = bos_case("apparent")
    setup = jax_camera_setup(cfg)
    vol, eps, Z_D = gradient_volume_between(setup)
    source, dot_x, dot_y = jax_bos_source(cfg, setup,
                                          np.random.default_rng(11))
    pseudo = dataclasses.replace(
        source, x=dot_x.astype(np.float64), y=dot_y.astype(np.float64),
        z=np.full(dot_x.shape, float(np.asarray(source.z).ravel()[0])),
        radiance=np.ones(dot_x.shape),
        diameter_index=np.zeros(dot_x.shape, np.int32))
    ref, ref_hit = jfields.paraxial_displacement_oracle(cfg, setup, vol,
                                                        pseudo)
    tcfg = port_config(cfg)
    got, hit = fields.paraxial_displacement_oracle(
        tcfg, camera_setup(tcfg), port_volume(vol), port_source(pseudo))
    np.testing.assert_array_equal(hit, ref_hit)
    assert hit.all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)
    _, disp = jfields.theoretical_deflection(
        rho_grad=4.0 / 4e5, magnification=setup.magnification, Z_D=Z_D,
        del_z=0.5 * setup.object_distance, rho_0=1.225 + 2.0,
        pixel_pitch=cfg.camera_design.pixel_pitch)
    np.testing.assert_allclose(np.abs(got[:, 0]), abs(disp), rtol=0.08)


def test_ray_statistics_matches_jax():
    """A bundle with culled (NaN) rays: the same counts as the JAX
    package's, as Python floats."""
    pos = _nan_rays(seed=3)
    pos[5, 1] = np.inf
    d = np.ones_like(pos)
    w = np.zeros(len(pos), np.float32)
    got = ray_statistics(RayBundle(torch.tensor(pos), torch.tensor(d),
                                   torch.tensor(w), torch.tensor(w)))
    ref = jax_ray_statistics(JaxBundle(jnp.asarray(pos), jnp.asarray(d),
                                       jnp.asarray(w), jnp.asarray(w)))
    assert got == ref and all(type(v) is float for v in got.values())
    assert 0.0 < got["survival_fraction"] < 1.0
    empty = torch.zeros((0, 3))
    assert ray_statistics(RayBundle(empty, empty, empty[:, 0], empty[:, 0])
                          )["survival_fraction"] == 0.0


def test_c18_flow_through_the_port(tmp_path):
    """tests/test_bos_pipeline.py:194-235 through the port: save_lightrays
    bins of both images, loaded by the port's analysis, give per-dot
    displacements at the paraxial closed form within that test's rtol
    0.10."""
    cfg = bos_case("apparent", n_dots=5, rays=32)
    setup = jax_camera_setup(cfg)
    _, eps, Z_D = gradient_volume_between(setup, n=16)
    n, extent = 16, 4e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z_dots = setup.object_distance
    z = np.linspace(z_dots - 0.6 * setup.object_distance,
                    z_dots - 0.1 * setup.object_distance, n)
    rho = 1.225 + 4.0 * (x[:, None, None] - x.min()) / (x.max() - x.min()) \
        * np.ones((1, n, n))
    vol_path = str(tmp_path / "rho.nrrd")
    fields.save_density_nrrd(vol_path, rho, x, x, z)
    tcfg = port_config(cfg)
    tcfg.density_gradients.density_gradient_filename = vol_path
    tcfg.output_data.save_lightrays = True
    tcfg.output_data.num_lightrays_save = 0
    tcfg.output_data.image_directory = str(tmp_path)
    result = pipeline.run_bos(tcfg, device="cpu")
    pos1 = light_rays.load_ray_data(
        str(tmp_path / "light-ray-positions" / "im1"))
    pos2 = light_rays.load_ray_data(
        str(tmp_path / "light-ray-positions" / "im2"))
    assert pos1.shape == pos2.shape and pos1.shape[0] > 0
    src = result.sources["bos"]
    rays_per_dot = src.num_rays // len(result.dot_positions["x"])
    res = light_rays.process_lightray_data(
        pos1, pos2, rays_per_dot=rays_per_dot,
        pixel_pitch=tcfg.camera_design.pixel_pitch, nx=256, ny=256)
    disp = res["displacement"][:, 0]
    expected_px = setup.magnification * Z_D * eps \
        / tcfg.camera_design.pixel_pitch
    assert np.isfinite(disp).sum() >= len(disp) - 1
    np.testing.assert_allclose(np.abs(disp[np.isfinite(disp)]),
                               expected_px, rtol=0.10)
    # the port's dumps hold the port's rays: the same source, traced whole
    march_fn = make_march_fn(pipeline._load_volume(tcfg,
                                                   torch.device("cpu")))
    r1, r2 = pipeline._lens_sample_pair(tcfg, src.lightray_number_per_particle)
    ref = render_rays(tcfg, result.setup, bos_source(
        tcfg, result.setup, np.random.default_rng(tcfg.seed))[0], r1, r2,
        march_fn=march_fn, device="cpu")
    np.testing.assert_array_equal(pos2, ref.pos.numpy())
