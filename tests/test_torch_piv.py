"""Port vs JAX: PIV with Mie scattering.  The Mie table and Bohren-Huffman
series, the PIV / image-driven scene functions, the render with the
per-particle Mie collapse (and its golden), run_piv end to end with and
without a density volume, save_result and the CLI."""
import copy
import dataclasses
import os

import numpy as np
import pytest
import scipy.io as sio

import jax

from photon_tpu.config import default_config as jax_default_config
from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.render_fast import \
    render_image_fast as jax_render_image_fast
from photon_tpu.models import scenes as jax_scenes
from photon_tpu.ops import mie as jax_mie
from photon_tpu.pipeline import run_piv as jax_run_piv
from photon_tpu.pipeline import save_result as jax_save_result
from photon_tpu.utils.rng import lens_samples as jax_lens_samples
from photon_tpu_torch.cli import main as cli_main
from photon_tpu_torch.compat import from_reference
from photon_tpu_torch.models import scenes
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.ops import mie
from photon_tpu_torch.pipeline import run_piv, run_simulation, save_result
from photon_tpu_torch.utils.nrrd_io import write_nrrd
from photon_tpu_torch.utils.png_io import write_png
from photon_tpu_torch.utils.tiff_io import read_tiff16
from tests.torch_port_helpers import port_config, rel_l1

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def assert_sources_equal(got, ref):
    """Every field of two LightfieldSources, bit for bit and dtype."""
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def golden_piv_config():
    """tests/test_golden.py::_render_piv_mie's scene (JAX config): 300
    particles x 32 rays on a 128^2 sensor, 9 diameters x 32 angles."""
    cfg = jax_default_config("piv")
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 128
    cfg.particle_field.particle_number = 300
    cfg.particle_field.lightray_number_per_particle = 32
    cfg.particle_field.mie_scattering_angle_number = 32
    cfg.particle_field.particle_diameter_number = 9
    m = cfg.lens_design.focal_length / (cfg.lens_design.object_distance
                                        - cfg.lens_design.focal_length)
    half = 0.7 * 128 * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.particle_field.X_Min, cfg.particle_field.X_Max = -half, half
    cfg.particle_field.Y_Min, cfg.particle_field.Y_Max = -half, half
    return cfg


# ---------------------------------------------------------------------------
# the Mie table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,refrel", [(0.3, 1.18), (5.0, 1.5 + 0.01j),
                                      (47.5, 1.1778), (160.0, 1.1778)])
def test_bhmie_matches_jax(x, refrel):
    got = mie.bhmie(x, refrel, 16)
    ref = jax_mie.bhmie(x, refrel, 16)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_mie_table_matches_jax():
    cfg = golden_piv_config()
    tcfg = port_config(cfg)
    ref = jax_mie.create_mie_scattering_data(cfg, np.random.default_rng(77))
    got = mie.create_mie_scattering_data(tcfg, np.random.default_rng(77))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["scattering_irradiance"].shape == (63, 9)
    assert got["particle_diameter_index_distribution"].shape == (300,)


# ---------------------------------------------------------------------------
# the scene functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mat_frames(tmp_path_factory):
    """Two particle frames as .mat files, as the reference's loader reads
    them (X, Y, Z columns)."""
    d = tmp_path_factory.mktemp("piv_frames")
    rng = np.random.default_rng(5)
    for i in (1, 2):
        xyz = {k: rng.uniform(-3e4, 3e4, (40, 1)) for k in ("X", "Y")}
        xyz["Z"] = rng.uniform(-5e2, 5e2, (40, 1))
        sio.savemat(str(d / f"particle_data_frame_{i:04d}.mat"), xyz)
    return str(d)


@pytest.mark.parametrize("scene", ["random", "single", "loaded", "diffuse",
                                   "rotated"])
def test_piv_source_matches_jax(scene, mat_frames):
    cfg = golden_piv_config()
    if scene == "single":
        cfg.particle_field.particle_number = 1
        cfg.particle_field.particle_depth = 120.0
    elif scene == "loaded":
        cfg.particle_field.load_particle_data = True
        cfg.particle_field.data_directory = mat_frames
        cfg.particle_field.particle_number = 30
    elif scene == "diffuse":
        cfg.particle_field.perform_mie_scattering = False
        cfg.particle_field.lightray_radiance = 77.0
    elif scene == "rotated":
        cfg.camera_design.x_camera_angle = 0.1
        cfg.camera_design.y_camera_angle = -0.05
    tcfg = port_config(cfg)
    jsetup, tsetup = jax_camera_setup(cfg), camera_setup(tcfg)
    idx = np.random.default_rng(3).integers(0, 8, 300).astype(np.int32)
    for frame in (1, 2):
        ref = jax_scenes.piv_source(cfg, jsetup, frame,
                                    diameter_index_distribution=idx,
                                    rng=np.random.default_rng(frame))
        got = scenes.piv_source(tcfg, tsetup, frame,
                                diameter_index_distribution=idx,
                                rng=np.random.default_rng(frame))
        assert_sources_equal(got, ref)
    if scene == "random":
        # the frame's own generator when none is passed
        assert_sources_equal(scenes.piv_source(tcfg, tsetup, 2,
                                               diameter_index_distribution=idx),
                             jax_scenes.piv_source(
                                 cfg, jsetup, 2,
                                 diameter_index_distribution=idx))
        with pytest.raises(ValueError, match="diameter index"):
            scenes.piv_source(tcfg, tsetup, 1)


@pytest.mark.parametrize("target", ["array", "png"])
def test_bos_image_source_matches_jax(target, tmp_path):
    from tests.test_bos_pipeline import bos_case
    cfg = bos_case("general", n_dots=4, rays=16)
    tcfg = port_config(cfg)
    img = np.zeros((24, 32), np.uint8)
    rng = np.random.default_rng(8)
    img[rng.integers(0, 24, 40), rng.integers(0, 32, 40)] = \
        rng.integers(1, 256, 40)
    if target == "png":
        path = str(tmp_path / "dots.png")
        write_png(path, img)
        image, kw = path, {}
    else:
        image, kw = img.astype(np.float32) / 255.0, dict(
            x_range=(-2e4, 2.5e4), y_range=(-1.5e4, 1e4))
    ref = jax_scenes.bos_image_source(cfg, jax_camera_setup(cfg), image, **kw)
    got = scenes.bos_image_source(tcfg, camera_setup(tcfg), image, **kw)
    assert got.num_particles == int((img > 0).sum())
    assert_sources_equal(got, ref)


def test_displace_source_matches_jax():
    cfg = golden_piv_config()
    idx = np.zeros(300, np.int32)
    src = jax_scenes.piv_source(cfg, jax_camera_setup(cfg), 1,
                                diameter_index_distribution=idx,
                                rng=np.random.default_rng(4))
    tsrc = scenes.piv_source(port_config(cfg), camera_setup(port_config(cfg)),
                             1, diameter_index_distribution=idx,
                             rng=np.random.default_rng(4))
    assert_sources_equal(scenes.displace_source(tsrc, 12.5, -3.0, 0.75),
                         jax_scenes.displace_source(src, 12.5, -3.0, 0.75))


# ---------------------------------------------------------------------------
# the render with the Mie collapse
# ---------------------------------------------------------------------------

def hold_to_golden(got, golden, centres, edge, most=2):
    """test_golden's tolerance (rtol 2e-3, atol 1e-6 of the maximum) on
    every pixel but those on the circular render mask's edge.  The mask
    keeps a pixel whose distance to its spot's centre is at most ``edge``
    (render_fraction * D); the centre is the fan's centroid, which the two
    packages round differently in the thick lens (the port's plain version
    as the card's kernel, without FMA contraction) by up to ~5e-4 px, so a
    pixel within that of the edge may be in one image and out of the other.
    A pixel that misses the tolerance must lie within 1e-3 px (chip_smoke's
    centroid tolerance for the fan kernel) of some spot's edge, and at most
    ``most`` such pixels may differ.  ``centres``: the port's (X, Y)."""
    tol = 2e-3 * np.abs(golden) + 1e-6 * max(golden.max(), 1.0)
    rows, cols = np.nonzero(np.abs(got - golden) > tol)
    X, Y = (np.asarray(c, np.float64) for c in centres)
    for r, c in zip(rows, cols):
        gap = np.abs(np.hypot(c - X, r - Y) - edge).min()
        print(f"pixel ({r}, {c}): port {got[r, c]:.6g}, golden "
              f"{golden[r, c]:.6g}, {gap:.2e} px from a spot's mask edge")
        assert gap < 1e-3, (r, c, gap)
    assert len(rows) <= most, len(rows)


def test_render_with_mie_matches_jax_and_the_golden(monkeypatch):
    """tests/test_golden.py::_render_piv_mie through both packages; the
    lens samples are JAX's, passed to both as numpy."""
    from photon_tpu_torch.models import render_fast
    cfg = golden_piv_config()
    rng = np.random.default_rng(77)
    setup = jax_camera_setup(cfg)
    scat = jax_mie.create_mie_scattering_data(cfg, rng)
    src = jax_scenes.piv_source(
        cfg, setup, 1, diameter_index_distribution=scat[
            "particle_diameter_index_distribution"], rng=rng)
    r1, r2 = (np.asarray(a) for a in jax_lens_samples(jax.random.key(9), 32))
    ref = np.asarray(jax_render_image_fast(cfg, setup, src, r1, r2,
                                           scattering=scat))

    tcfg = port_config(cfg)
    trng = np.random.default_rng(77)
    tsetup = camera_setup(tcfg)
    tscat = mie.create_mie_scattering_data(tcfg, trng)
    tsrc = scenes.piv_source(
        tcfg, tsetup, 1, diameter_index_distribution=tscat[
            "particle_diameter_index_distribution"], rng=trng)
    centres = []
    splat = render_fast.particle_splat

    def keep_centres(Xbar, Ybar, *a, **kw):
        centres.append((Xbar.numpy(), Ybar.numpy()))
        return splat(Xbar, Ybar, *a, **kw)

    monkeypatch.setattr(render_fast, "particle_splat", keep_centres)
    got = render_image_fast(tcfg, tsetup, tsrc, r1, r2, scattering=tscat,
                            device="cpu").numpy()
    l1 = rel_l1(got, ref)
    print(f"piv_mie_128: L1 {l1:.3g} of the JAX render's sum")
    assert l1 < 1e-3, l1
    golden = np.load(os.path.join(GOLDEN_DIR, "piv_mie_128.npy"))
    assert got.sum() > 0
    print(f"piv_mie_128: L1 {rel_l1(got, golden):.3g} of the golden's sum")
    assert rel_l1(got, golden) < 1e-3
    hold_to_golden(got, golden, centres[0], edge=0.75 * 3.0)
    # the Mie factor moves the image: diffuse radiance renders another one
    diffuse = render_image_fast(tcfg, tsetup, tsrc, r1, r2,
                                device="cpu").numpy()
    assert rel_l1(diffuse, got) > 0.1


def test_mie_factor_matches_jax_per_particle():
    """The collapse itself: rad * irradiance per particle, against the JAX
    package's arithmetic (render_fast.py:690-712) on a few hundred
    particles, to float32 rounding."""
    from photon_tpu_torch.models.render import RenderParams
    from photon_tpu_torch.models.render_fast import mie_irradiance
    cfg = golden_piv_config()
    cfg.particle_field.particle_number = 400
    cfg.particle_field.beam_propogation_vector = (0.3, 1.0, -0.2)
    tcfg = port_config(cfg)
    rng = np.random.default_rng(2)
    scat = mie.create_mie_scattering_data(tcfg, rng)
    setup = camera_setup(tcfg)
    src = scenes.piv_source(tcfg, setup, 1, diameter_index_distribution=scat[
        "particle_diameter_index_distribution"], rng=rng)
    params = RenderParams.from_setup(tcfg, setup, src)
    got = mie_irradiance(params.image_distance, src, scat)
    # the JAX package's lines, on its own copy of the table
    jscat = jax_mie.create_mie_scattering_data(cfg, np.random.default_rng(2))
    angles = jscat["scattering_angle"]
    table = np.asarray(jscat["scattering_irradiance"], np.float32)
    beam = jscat["beam_propogation_vector"]
    dden = params.image_distance - src.z.astype(np.float64)
    ctx, cty = src.x.astype(np.float64) / dden, src.y.astype(np.float64) / dden
    cinv = 1.0 / np.sqrt(ctx * ctx + cty * cty + 1.0)
    ang = np.arccos(np.clip(beam[0] * ctx * cinv + beam[1] * cty * cinv
                            - beam[2] * cinv, -1.0, 1.0))
    a = (ang - angles[0]) / (angles[1] - angles[0])
    a0 = np.clip(np.floor(a).astype(np.int32), 0, table.shape[0] - 2)
    frac = (a - a0).astype(np.float32)
    d = src.diameter_index
    ref = table[a0, d] + frac * (table[a0 + 1, d] - table[a0, d])
    assert got.dtype == np.float32 and got.shape == (400,)
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)
    assert len(np.unique(d)) > 3 and np.ptp(got) > 0
    with pytest.raises(KeyError, match="beam_propogation_vector"):
        mie_irradiance(params.image_distance, src,
                       {k: scat[k] for k in ("scattering_angle",
                                             "scattering_irradiance")})


def test_from_reference_carries_the_mie_table():
    cfg = golden_piv_config()
    scat = jax_mie.create_mie_scattering_data(cfg, np.random.default_rng(1))
    got = from_reference(scattering=scat, device="cpu")["scattering"]
    assert set(got) == {"scattering_angle", "scattering_irradiance",
                        "beam_propogation_vector",
                        "particle_diameter_index_distribution"}
    for k in got:
        np.testing.assert_array_equal(got[k], scat[k], err_msg=k)
    assert got["particle_diameter_index_distribution"].dtype == np.int32
    assert got["scattering_irradiance"].dtype == np.float64
    assert got["scattering_angle"].dtype == np.float64
    with pytest.raises(KeyError, match="scattering_angle"):
        from_reference(scattering={"scattering_irradiance": np.ones((3, 2))},
                       device="cpu")


# ---------------------------------------------------------------------------
# run_piv end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def piv_case(tmp_path_factory):
    """A small PIV case with Mie (150 particles x 16 rays, 128 x 96
    sensor, two frames, 40 particles a chunk), and the same with the small
    ramp volume of tests/test_torch_pipeline.py's case."""
    d = tmp_path_factory.mktemp("piv")
    cfg = jax_default_config("piv")
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
    pf = cfg.particle_field
    pf.particle_number = 150
    pf.lightray_number_per_particle = 16
    pf.lightray_process_number = 40 * 16
    pf.mie_scattering_angle_number = 32
    pf.particle_diameter_number = 9
    m = cfg.lens_design.focal_length / (cfg.lens_design.object_distance
                                        - cfg.lens_design.focal_length)
    half = 0.7 * 96 * cfg.camera_design.pixel_pitch / 2.0 / m
    pf.X_Min, pf.X_Max, pf.Y_Min, pf.Y_Max = -half, half, -half, half
    cfg.reference_lens_rng = True       # both sides draw GlibcRand samples
    setup = jax_camera_setup(cfg)
    w, h, dd = 12, 10, 14
    x = np.linspace(-2e5, 2e5, w)
    y = np.linspace(-2e5, 2e5, h)
    z = np.linspace(setup.object_distance * 0.4,
                    setup.object_distance * 0.9, dd)
    rho = 1.225 + 4.0 * (x[:, None, None] - x.min()) / (x.max() - x.min()) \
        * np.ones((1, h, dd))
    nrrd = str(d / "rho.nrrd")
    write_nrrd(nrrd, rho.astype(np.float32),
               spacings=(x[1] - x[0], y[1] - y[0], z[1] - z[0]),
               space_origin=(x[0], y[0], z[0]))
    cfg_vol = copy.deepcopy(cfg)
    cfg_vol.density_gradients.simulate_density_gradients = True
    cfg_vol.density_gradients.density_gradient_filename = nrrd
    return dict(dir=d, jax_cfg=cfg, torch_cfg=port_config(cfg),
                jax_cfg_vol=cfg_vol, torch_cfg_vol=port_config(cfg_vol))


@pytest.fixture(scope="module")
def results(piv_case):
    out = {}
    for tag, suffix in (("plain", ""), ("volume", "_vol")):
        ref = jax_run_piv(piv_case["jax_cfg" + suffix],
                          rng=np.random.default_rng(11))
        got = run_piv(piv_case["torch_cfg" + suffix],
                      rng=np.random.default_rng(11), device="cpu")
        out[tag] = (ref, got)
    return out


@pytest.mark.parametrize("tag", ["plain", "volume"])
def test_run_piv_matches_jax(results, tag):
    ref, got = results[tag]
    names = ["particle_image_frame_0001", "particle_image_frame_0002"]
    assert list(got.raw_images) == list(ref.raw_images) == names
    for name in names:
        a, b = got.raw_images[name], ref.raw_images[name]
        assert a.shape == b.shape == (96, 128) and a.dtype == np.float32
        l1 = rel_l1(a, b)
        print(f"{tag}, {name}: raw L1 {l1:.3g}")
        assert l1 < 1e-3, l1
        # the frames' particles, drawn after the Mie table from one rng
        assert_sources_equal(got.sources[name], ref.sources[name])
    f1, f2 = (got.raw_images[n] for n in names)
    assert np.abs(f1 - f2).sum() > 0.1 * f1.sum()
    assert set(got.timer.phases) == {
        "scene", "mie", "postprocess", *(f"render:{n}" for n in names)} | (
            {"volume"} if tag == "volume" else set())


def test_the_volume_moves_the_piv_frames(results):
    name = "particle_image_frame_0001"
    plain = results["plain"][1].raw_images[name]
    bent = results["volume"][1].raw_images[name]
    assert rel_l1(bent, plain) > 1e-2


@pytest.mark.parametrize("tag", ["plain", "volume"])
def test_quantised_piv_images_match_jax(results, tag):
    ref, got = results[tag]
    level = 65535.0 / 1023.0            # one 10-bit level in 16-bit counts
    for name in ref.images:
        a = got.images[name].astype(np.int64)
        b = np.asarray(ref.images[name]).astype(np.int64)
        assert got.images[name].dtype == np.uint16
        diff = np.abs(a - b)
        assert diff.max() <= np.ceil(level), diff.max()
        share = float((diff > 0).mean())
        print(f"{tag}, {name}: {share:.4%} of pixels differ by one level")
        assert share < 0.01, share


def test_save_result_writes_the_same_piv_files(piv_case, results):
    ref, got = results["plain"]
    out_t = str(piv_case["dir"] / "out_torch")
    out_j = str(piv_case["dir"] / "out_jax")
    written = save_result(piv_case["torch_cfg"], got, out_t)
    written_j = jax_save_result(piv_case["jax_cfg"], ref, out_j)
    rel = lambda paths, root: sorted(os.path.relpath(p, root) for p in paths)
    assert rel(written, out_t) == rel(written_j, out_j)
    assert "tif/particle_image_frame_0002.tif" in rel(written, out_t)
    assert not any("positions" in p for p in written)
    img = read_tiff16(os.path.join(out_t, "tif",
                                   "particle_image_frame_0002.tif"))
    np.testing.assert_array_equal(img,
                                  got.images["particle_image_frame_0002"])


def test_cli_runs_a_piv_case_on_the_cpu(piv_case):
    cfg = copy.deepcopy(piv_case["torch_cfg_vol"])
    cfg.particle_field.particle_number = 40
    cfg_path = str(piv_case["dir"] / "piv.json")
    cfg.to_json(cfg_path)
    out = str(piv_case["dir"] / "out_cli")
    assert cli_main([cfg_path, "--out", out, "--device", "cpu"]) == 0
    tifs = sorted(os.listdir(os.path.join(out, "tif")))
    assert tifs == ["particle_image_frame_0001.tif",
                    "particle_image_frame_0002.tif"]
    im = read_tiff16(os.path.join(out, "tif", tifs[0]))
    assert im.shape == (96, 128) and im.sum() > 0


def test_run_simulation_dispatches_piv(piv_case):
    cfg = copy.deepcopy(piv_case["torch_cfg"])
    cfg.particle_field.particle_number = 10
    cfg.particle_field.frame_vector = (3,)
    res = run_simulation(cfg, device="cpu")
    assert list(res.raw_images) == ["particle_image_frame_0003"]
    assert res.dot_positions is None
