"""Port vs JAX: calibration grids.  calibration_source on its first and
last planes, the render of a plane (and its golden), run_cal end to end,
save_result and the CLI."""
import copy
import os

import numpy as np
import pytest

import jax

from photon_tpu.config import default_config as jax_default_config
from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.render_fast import \
    render_image_fast as jax_render_image_fast
from photon_tpu.models.scenes import calibration_source as jax_cal_source
from photon_tpu.pipeline import run_cal as jax_run_cal
from photon_tpu.pipeline import save_result as jax_save_result
from photon_tpu.utils.rng import lens_samples as jax_lens_samples
from photon_tpu_torch.cli import main as cli_main
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.models.scenes import calibration_source
from photon_tpu_torch.pipeline import run_cal, save_result
from photon_tpu_torch.utils.tiff_io import read_tiff16
from tests.test_torch_piv import GOLDEN_DIR, assert_sources_equal
from tests.torch_port_helpers import port_config, rel_l1


def golden_cal_config():
    """tests/test_golden.py::_render_cal_plane's scene (JAX config): a 5 x 5
    grid of 64-point dots, 16 rays, 128^2 sensor."""
    cfg = jax_default_config("cal")
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 128
    cg = cfg.calibration_grid
    cg.x_grid_point_number = 5
    cg.y_grid_point_number = 5
    cg.x_grid_point_spacing = 8e3
    cg.y_grid_point_spacing = 8e3
    cg.grid_point_diameter = 1.5e3
    cg.particle_number_per_grid_point = 64
    cg.lightray_number_per_particle = 16
    return cfg


@pytest.mark.parametrize("rotated", [False, True])
def test_calibration_source_matches_jax(rotated):
    cfg = golden_cal_config()
    cfg.calibration_grid.particle_number_per_grid_point = 1000  # 62.5 marks
    if rotated:
        cfg.camera_design.x_camera_angle = 0.1
        cfg.camera_design.y_camera_angle = 0.2
    tcfg = port_config(cfg)
    jsetup, tsetup = jax_camera_setup(cfg), camera_setup(tcfg)
    last = cfg.calibration_grid.calibration_plane_number - 1
    for plane in (0, last):
        ref = jax_cal_source(cfg, jsetup, plane, np.random.default_rng(13))
        got = calibration_source(tcfg, tsetup, plane,
                                 np.random.default_rng(13))
        assert_sources_equal(got, ref)
    # the default generator, and the planes' depths
    assert_sources_equal(calibration_source(tcfg, tsetup, last),
                         jax_cal_source(cfg, jsetup, last))
    z0 = calibration_source(tcfg, tsetup, 0).z
    zl = calibration_source(tcfg, tsetup, last).z
    if not rotated:
        np.testing.assert_allclose(zl - z0, 6e3, rtol=1e-4)


def test_render_of_a_plane_matches_jax_and_the_golden():
    cfg = golden_cal_config()
    setup = jax_camera_setup(cfg)
    src = jax_cal_source(cfg, setup, 0, np.random.default_rng(13))
    r1, r2 = (np.asarray(a) for a in jax_lens_samples(jax.random.key(4), 16))
    ref = np.asarray(jax_render_image_fast(cfg, setup, src, r1, r2))
    tcfg = port_config(cfg)
    tsetup = camera_setup(tcfg)
    tsrc = calibration_source(tcfg, tsetup, 0, np.random.default_rng(13))
    got = render_image_fast(tcfg, tsetup, tsrc, r1, r2, device="cpu").numpy()
    l1 = rel_l1(got, ref)
    print(f"cal_plane_128: L1 {l1:.3g} of the JAX render's sum")
    assert l1 < 1e-3, l1
    golden = np.load(os.path.join(GOLDEN_DIR, "cal_plane_128.npy"))
    assert got.sum() > 0
    np.testing.assert_allclose(got, golden, rtol=2e-3,
                               atol=1e-6 * max(golden.max(), 1.0))


# ---------------------------------------------------------------------------
# run_cal end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cal_case(tmp_path_factory):
    """Three planes of a 5 x 5 grid of 24-point dots (plus the markers),
    12 rays, 128 x 96 sensor, 100 particles a chunk."""
    d = tmp_path_factory.mktemp("cal")
    cfg = golden_cal_config()
    cfg.camera_design.y_pixel_number = 96
    cg = cfg.calibration_grid
    cg.calibration_plane_number = 3
    cg.particle_number_per_grid_point = 24
    cg.lightray_number_per_particle = 12
    cg.lightray_process_number = 100 * 12
    cfg.reference_lens_rng = True       # both sides draw GlibcRand samples
    return dict(dir=d, jax_cfg=cfg, torch_cfg=port_config(cfg))


@pytest.fixture(scope="module")
def results(cal_case):
    ref = jax_run_cal(cal_case["jax_cfg"], rng=np.random.default_rng(11))
    got = run_cal(cal_case["torch_cfg"], rng=np.random.default_rng(11),
                  device="cpu")
    return ref, got


def test_run_cal_matches_jax(results):
    ref, got = results
    names = [f"calibration_image_plane_{i:04d}" for i in (1, 2, 3)]
    assert list(got.raw_images) == list(ref.raw_images) == names
    for name in names:
        a, b = got.raw_images[name], ref.raw_images[name]
        assert a.shape == b.shape == (96, 128) and a.dtype == np.float32
        l1 = rel_l1(a, b)
        print(f"{name}: raw L1 {l1:.3g}")
        assert l1 < 1e-3, l1
        assert_sources_equal(got.sources[name], ref.sources[name])
    assert all(got.raw_images[n].sum() > 0 for n in names)
    assert set(got.timer.phases) == {
        "scene", "postprocess", *(f"render:{n}" for n in names)}


def test_quantised_cal_images_match_jax(results):
    ref, got = results
    level = 65535.0 / 1023.0            # one 10-bit level in 16-bit counts
    for name in ref.images:
        a = got.images[name].astype(np.int64)
        b = np.asarray(ref.images[name]).astype(np.int64)
        assert got.images[name].dtype == np.uint16
        diff = np.abs(a - b)
        assert diff.max() <= np.ceil(level), diff.max()
        share = float((diff > 0).mean())
        print(f"{name}: {share:.4%} of pixels differ by one level")
        assert share < 0.01, share


def test_save_result_writes_the_same_cal_files(cal_case, results):
    ref, got = results
    out_t = str(cal_case["dir"] / "out_torch")
    out_j = str(cal_case["dir"] / "out_jax")
    written = save_result(cal_case["torch_cfg"], got, out_t)
    written_j = jax_save_result(cal_case["jax_cfg"], ref, out_j)
    rel = lambda paths, root: sorted(os.path.relpath(p, root) for p in paths)
    assert rel(written, out_t) == rel(written_j, out_j)
    raw = np.fromfile(os.path.join(out_t, "raw",
                                   "calibration_image_plane_0003.bin"),
                      np.float32).reshape(96, 128)
    np.testing.assert_array_equal(
        raw, got.raw_images["calibration_image_plane_0003"])


def test_cli_runs_a_cal_case_on_the_cpu(cal_case):
    cfg = copy.deepcopy(cal_case["torch_cfg"])
    cfg.calibration_grid.calibration_plane_number = 2
    cfg_path = str(cal_case["dir"] / "cal.json")
    cfg.to_json(cfg_path)
    out = str(cal_case["dir"] / "out_cli")
    assert cli_main([cfg_path, "--out", out, "--device", "cpu"]) == 0
    tifs = sorted(os.listdir(os.path.join(out, "tif")))
    assert tifs == ["calibration_image_plane_0001.tif",
                    "calibration_image_plane_0002.tif"]
    im = read_tiff16(os.path.join(out, "tif", tifs[1]))
    assert im.shape == (96, 128) and im.sum() > 0
