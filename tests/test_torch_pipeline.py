"""Port vs JAX: the BOS image pair end to end (run_bos, save_result, CLI)
and the state that crosses between the packages."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.scenes import bos_source as jax_bos_source
from photon_tpu.pipeline import run_bos as jax_run_bos
from photon_tpu.pipeline import save_result as jax_save_result
from photon_tpu.volume import load_density_volume as jax_load_volume
from photon_tpu_torch.cli import main as cli_main
from photon_tpu_torch.compat import from_reference
from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.pipeline import run_bos, run_simulation, save_result
from photon_tpu_torch.utils.nrrd_io import write_nrrd
from photon_tpu_torch.utils.tiff_io import read_tiff16
from photon_tpu_torch.volume import load_density_volume
from tests.test_bos_pipeline import bos_case
from tests.torch_port_helpers import (port_config, port_source, port_volume,
                                      rel_l1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """One small BOS case with a volume written once by the port's NRRD
    writer; both packages read it.  W != H != D."""
    d = tmp_path_factory.mktemp("bos")
    cfg = bos_case("general", n_dots=4, rays=16)
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
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
    cfg.density_gradients.simulate_density_gradients = True
    cfg.density_gradients.density_gradient_filename = nrrd
    return dict(dir=d, jax_cfg=cfg, torch_cfg=port_config(cfg))


@pytest.fixture(scope="module")
def results(case):
    ref = jax_run_bos(case["jax_cfg"], rng=np.random.default_rng(11))
    got = run_bos(case["torch_cfg"], rng=np.random.default_rng(11),
                  device="cpu")
    return ref, got


def test_raw_images_match_jax(results):
    ref, got = results
    assert set(got.raw_images) == set(ref.raw_images) == {
        "bos_pattern_image_1", "bos_pattern_image_2"}
    for name in ref.raw_images:
        a, b = got.raw_images[name], ref.raw_images[name]
        assert a.shape == b.shape == (96, 128) and a.dtype == np.float32
        l1 = rel_l1(a, b)
        print(f"{name}: raw L1 {l1:.3g}")
        # the JAX package's fast-vs-exact budget (tests/test_fast.py)
        assert l1 < 1e-3, l1
    im1, im2 = (got.raw_images[n] for n in sorted(got.raw_images))
    assert np.abs(im1 - im2).sum() > 1e-3 * im1.sum()
    np.testing.assert_array_equal(got.dot_positions["x"],
                                  ref.dot_positions["x"])


@pytest.mark.parametrize("algorithm,scheme", [(2, 2), (3, 1), (4, 1)])
def test_run_bos_matches_jax_across_the_march_menu(case, algorithm, scheme):
    """The config's ray_tracing_algorithm and interpolation_scheme reach the
    march: tricubic RK4, RK4 with substeps chosen from the data, and
    Adams-Bashforth, im2 within L1 1e-3 of the JAX package's."""
    import copy
    name = "bos_pattern_image_2"
    pair = []
    for cfg, run in ((case["jax_cfg"], jax_run_bos),
                     (case["torch_cfg"], run_bos)):
        cfg = copy.deepcopy(cfg)
        cfg.density_gradients.ray_tracing_algorithm = algorithm
        cfg.density_gradients.interpolation_scheme = scheme
        kw = {} if run is jax_run_bos else dict(device="cpu")
        pair.append(run(cfg, rng=np.random.default_rng(11), **kw))
    ref, got = pair
    l1 = rel_l1(got.raw_images[name], ref.raw_images[name])
    print(f"algorithm {algorithm} scheme {scheme}: im2 L1 {l1:.3g}")
    assert l1 < 1e-3, l1


def test_quantised_images_match_jax(results):
    ref, got = results
    level = 65535.0 / 1023.0            # one 10-bit level in 16-bit counts
    for name in ref.images:
        a = got.images[name].astype(np.int64)
        b = np.asarray(ref.images[name]).astype(np.int64)
        assert got.images[name].dtype == np.uint16
        diff = np.abs(a - b)
        # rounding to 10 bits flips where a pixel sits within f32 noise of
        # a half level: at most one level, on under 1% of the pixels
        assert diff.max() <= np.ceil(level), diff.max()
        share = float((diff > 0).mean())
        print(f"{name}: {share:.4%} of pixels differ by one level")
        assert share < 0.01, share


def test_save_result_writes_the_same_files(case, results):
    ref, got = results
    out_t = str(case["dir"] / "out_torch")
    out_j = str(case["dir"] / "out_jax")
    written = save_result(case["torch_cfg"], got, out_t)
    written_j = jax_save_result(case["jax_cfg"], ref, out_j)
    rel = lambda paths, root: sorted(os.path.relpath(p, root) for p in paths)
    assert rel(written, out_t) == rel(written_j, out_j)
    assert all(os.path.exists(p) for p in written)
    img = read_tiff16(os.path.join(out_t, "tif", "bos_pattern_image_2.tif"))
    np.testing.assert_array_equal(img, got.images["bos_pattern_image_2"])
    raw = np.fromfile(os.path.join(out_t, "raw", "bos_pattern_image_2.bin"),
                      np.float32).reshape(96, 128)
    np.testing.assert_array_equal(raw, got.raw_images["bos_pattern_image_2"])
    cfg2 = SimulationConfig.from_mat(os.path.join(out_t, "parameters.mat"))
    assert cfg2.bos_pattern.grid_point_number == 4


def test_cli_runs_on_the_cpu(case):
    cfg_path = str(case["dir"] / "case.json")
    case["torch_cfg"].to_json(cfg_path)
    out = str(case["dir"] / "out_cli")
    assert cli_main([cfg_path, "--out", out, "--device", "cpu"]) == 0
    tifs = sorted(os.listdir(os.path.join(out, "tif")))
    assert tifs == ["bos_pattern_image_1.tif", "bos_pattern_image_2.tif"]
    im1 = read_tiff16(os.path.join(out, "tif", tifs[0]))
    im2 = read_tiff16(os.path.join(out, "tif", tifs[1]))
    assert im1.shape == (96, 128) and im1.sum() > 0
    assert np.abs(im1.astype(np.int64) - im2.astype(np.int64)).sum() > 0


def test_from_reference_round_trips(case):
    cfg = case["jax_cfg"]
    tcfg = case["torch_cfg"]
    assert json.loads(tcfg.to_json()) == json.loads(cfg.to_json())

    jv = jax_load_volume(cfg.density_gradients.density_gradient_filename)
    tv = port_volume(jv)
    own = load_density_volume(cfg.density_gradients.density_gradient_filename,
                              device="cpu")
    assert tuple(tv.sizes) == (12, 10, 14) == tuple(own.sizes)
    for a, b in zip(tv, own):           # carried over == loaded by the port
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        elif isinstance(a, np.ndarray):     # the geometry stays on the host
            assert a.dtype == np.float32 and b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    np.testing.assert_array_equal(tv.field.numpy(), np.asarray(jv.field))

    setup = jax_camera_setup(cfg)
    src, *_ = jax_bos_source(cfg, setup, np.random.default_rng(11))
    ts = port_source(src)
    for f in dataclasses.fields(src):
        a, b = getattr(ts, f.name), getattr(src, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    r = from_reference(r1=np.linspace(0, 1, 5), r2=np.ones(5), device="cpu")
    assert r["r1"].dtype == torch.float32 and r["r2"].shape == (5,)
    with pytest.raises(KeyError):
        from_reference(volume={"field": np.zeros((3, 3, 3, 4))}, device="cpu")


@pytest.mark.parametrize("edit", ["piv", "cal", "save_lightrays",
                                  "ngrad_noise"])
def test_later_slices_raise(case, edit):
    import copy
    cfg = copy.deepcopy(case["torch_cfg"])
    if edit in ("piv", "cal"):
        cfg.simulation_type = edit
    elif edit == "save_lightrays":
        cfg.output_data.save_lightrays = True
    else:
        cfg.density_gradients.add_ngrad_noise = True
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_simulation(cfg, device="cpu")


# ---------------------------------------------------------------------------
# a case whose NRRD has slabs over 256 x 256 voxels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def large_case(tmp_path_factory):
    """The small case above with a 288 x 272 x 6 density ramp: beyond the JAX
    package's dense cap, so its side runs the windowed march."""
    d = tmp_path_factory.mktemp("bos_large")
    cfg = bos_case("general", n_dots=4, rays=16)
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
    cfg.reference_lens_rng = True
    setup = jax_camera_setup(cfg)
    w, h, dd = 288, 272, 6
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
    cfg.density_gradients.simulate_density_gradients = True
    cfg.density_gradients.density_gradient_filename = nrrd
    return dict(dir=d, jax_cfg=cfg, torch_cfg=port_config(cfg))


def test_run_bos_through_a_large_slab_matches_jax(large_case):
    from photon_tpu.ops.march_dense import dense_march_supported
    jv = jax_load_volume(
        large_case["jax_cfg"].density_gradients.density_gradient_filename)
    assert not dense_march_supported(jv)
    ref = jax_run_bos(large_case["jax_cfg"], rng=np.random.default_rng(11))
    got = run_bos(large_case["torch_cfg"], rng=np.random.default_rng(11),
                  device="cpu")
    for name in sorted(ref.raw_images):
        l1 = rel_l1(got.raw_images[name], ref.raw_images[name])
        print(f"288 x 272 x 6, {name}: raw L1 {l1:.3g}")
        # the windowed march against the tube march in the JAX package's own
        # test of this route: 2e-3 of the sum
        assert l1 < 2e-3, l1
    im1, im2 = (got.raw_images[n] for n in sorted(got.raw_images))
    assert np.abs(im1 - im2).sum() > 1e-3 * im1.sum()


@pytest.mark.parametrize("algorithm,scheme", [(2, 1), (3, 2), (4, 1)])
def test_cli_through_a_large_slab_on_the_cpu(large_case, algorithm, scheme):
    import copy
    cfg = copy.deepcopy(large_case["torch_cfg"])
    cfg.density_gradients.ray_tracing_algorithm = algorithm
    cfg.density_gradients.interpolation_scheme = scheme
    cfg_path = str(large_case["dir"] / f"case_{algorithm}_{scheme}.json")
    cfg.to_json(cfg_path)
    out = str(large_case["dir"] / f"out_cli_{algorithm}_{scheme}")
    assert cli_main([cfg_path, "--out", out, "--device", "cpu"]) == 0
    im1 = read_tiff16(os.path.join(out, "tif", "bos_pattern_image_1.tif"))
    im2 = read_tiff16(os.path.join(out, "tif", "bos_pattern_image_2.tif"))
    assert im1.shape == (96, 128) and im1.sum() > 0
    assert np.abs(im1.astype(np.int64) - im2.astype(np.int64)).sum() > 0
