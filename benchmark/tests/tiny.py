"""The cells' configurations and traffic at a size the CPU runs in seconds:
the same files, with the sensor, the particles, the rays and the grid cut
down, so that a test drives the harness end to end with the plain
versions."""
from __future__ import annotations

import copy
import json

from benchmark.core import spec as S


def bos(sensor=64, dots=6, points=10, rays=12, grid=(10, 10, 9)):
    doc = copy.deepcopy(S.config_doc(S.load_spec(), "bos_bench_512"))
    sim = doc["simulation"]
    sim["camera_design"]["x_pixel_number"] = sensor
    sim["camera_design"]["y_pixel_number"] = sensor
    bp = sim["bos_pattern"]
    scale = sensor / 1024.0
    for k in ("X_Min", "X_Max", "Y_Min", "Y_Max"):
        bp[k] *= scale
    bp["grid_point_number"] = dots
    bp["particle_number_per_grid_point"] = points
    bp["lightray_number_per_particle"] = rays
    doc["volume"]["sizes"] = list(grid)
    return doc


def piv(sensor=64, particles=120, rays=40, budget=800):
    doc = copy.deepcopy(S.config_doc(S.load_spec(), "piv_sample"))
    sim = doc["simulation"]
    sim["camera_design"]["x_pixel_number"] = sensor
    sim["camera_design"]["y_pixel_number"] = sensor
    pf = sim["particle_field"]
    scale = sensor / 1024.0
    for k in ("X_Min", "X_Max", "Y_Min", "Y_Max"):
        pf[k] *= scale
    pf["particle_number"] = particles
    pf["lightray_number_per_particle"] = rays
    pf["lightray_process_number"] = budget
    return doc


def traffic(name, **over):
    with open(S.BENCH / "traffic" / f"{name}.json") as f:
        doc = json.load(f)
    doc.update(over)
    return doc
