"""Shared pieces of the benchmark's own tests: a copy of the benchmark
whose cells run at a size the CPU holds, and the ``cuda`` marker."""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the benchmark's runs); skips without one")


@pytest.fixture
def card():
    """Skips the test without a CUDA device (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card only")
    return "cuda"


def shrink(config: dict, traffic: dict):
    """The cell at a size the CPU holds: the dense 32-line profile at 64
    azimuth steps (no dropout, no angle noise), a coarse mesh and recon
    voxel, few points.  At 20,000
    TLS points a tenth of the normals sit where the program's grid k-NN
    and the exact one take other neighbours (a few per mille at 600,000),
    so the normals' limit is that of this size."""
    sim = config.get("simulation") or config["pipeline"]["simulation"]
    sim.update(num_waypoints=3, use_blk2go=False, use_dense_lidar=True, lidar_horizontal_res=64)
    config["lidar"].update(rays_per_scan=32 * 64, dropout_probability=0.0, pattern={
        "kind": "grid", "horizontal_res": 64,
        "vertical_degrees": [round(15.0 - i * 35.0 / 31.0, 1) for i in range(32)]})
    if "pipeline" in config:
        config["pipeline"]["nksr"]["voxel_size"] = 0.1
        config["limits"]["normal_off_share"] = 0.2
    traffic.update(pool_rooms=2, tls_points=20_000, hit_samples_per_room=500,
                   label_samples_per_room=500)
    if "mesh_voxel_m" in traffic:
        traffic.update(rooms_per_call=2, mesh_voxel_m=0.5)
    if "normal_samples_per_room" in traffic:
        traffic.update(normal_samples_per_room=300)


def make_tiny_bench(dest: Path) -> Path:
    """``dest`` holding the benchmark's code (links) and its cells' files
    shrunk; returns the path of its BENCHMARK.json."""
    for folder in ("entries", "e2e", "metrics"):
        os.symlink(BENCH / folder, dest / folder)
    bench = with_pipeline(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for sub in ("configs", "traffic"):
        (dest / sub).mkdir()
    for cell in bench["workloads"]:
        config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
        traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
        shrink(config, traffic)
        (dest / "configs" / f"{cell['config']}.json").write_text(json.dumps(config))
        (dest / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(traffic))
    path = dest / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


# The pipeline cell's entries: out of BENCHMARK.json while the program's
# grid k-NN removes inliers (PERF.md, Open questions), and added here as a
# later PR adds a cell, so that its entry, configuration and traffic stay
# tested.
PIPELINE_CELL = {
    "configs": [
        {
            "name": "s3dis-office-pipeline",
            "source": "Indoor-Point-Cloud-Datasets-Controllable-Generation-Method-for-Mobile-Robots-3D-Scene-Perception configs/s3dis_config.yaml, all blocks, five stages a room; S3DIS (Armeni et al. CVPR 2016)",
            "file": "benchmark/configs/s3dis-office-pipeline.json",
            "reduced": [
                "save_visualizations"
            ],
            "why": "all five stages of a room as upstream's run_pipeline runs them: preprocess, recon at voxel 0.03, BLK2GO sim, bbox, eval"
        }
    ],
    "workloads": [
        {
            "name": "pipeline.office.blk2go",
            "config": "s3dis-office-pipeline",
            "traffic": "office-serial",
            "chips": 1,
            "why": "run() on one fresh 600k-point TLS office a call, closed loop: recon's host work carries a room, the label prefetch hides behind it; the control for the label join"
        }
    ],
    "end_to_end": [
        {
            "name": "pipeline_rooms_per_h",
            "unit": "rooms/h",
            "better": "higher",
            "bound": 0.25,
            "source": "host_clock",
            "workloads": [
                "pipeline.office.blk2go"
            ]
        }
    ],
    "per_layer": [
        {
            "name": "preprocess_s.pipeline",
            "unit": "s",
            "better": "lower",
            "source": "program_span",
            "layer": "preprocess",
            "moves": "pipeline_rooms_per_h",
            "workloads": [
                "pipeline.office.blk2go"
            ]
        },
        {
            "name": "recon_s.pipeline",
            "unit": "s",
            "better": "lower",
            "source": "program_span",
            "layer": "recon",
            "moves": "pipeline_rooms_per_h",
            "workloads": [
                "pipeline.office.blk2go"
            ]
        },
        {
            "name": "device_idle.pipeline",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "pipeline_rooms_per_h",
            "workloads": [
                "pipeline.office.blk2go"
            ]
        }
    ]
}


def with_pipeline(bench: dict) -> dict:
    """``bench`` with the pipeline cell's entries added."""
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + [e for e in PIPELINE_CELL[key] if e not in bench[key]]
    return bench


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """(bench dir, BENCHMARK.json path) of the shrunk benchmark; the runs'
    work directories go under ``tmp_path``."""
    d = tmp_path / "bench"
    d.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return d, make_tiny_bench(d)
