"""Typed configuration tree covering all five pipeline stages.

The reference scatters configuration across one YAML (consumed only by the
two upstream stages, configs/s3dis_config.yaml), hard-coded dicts in the
simulator mains (s3dis_simulator.py:597-612), and argparse-only tools
(SURVEY.md §5.6).  Here one dataclass tree covers preprocess, reconstruction,
simulation, bbox, and evaluation; YAML round-trips; plain-dict access stays
compatible with the reference's ``config['nksr']``-style lookups.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class DataConfig:
    """Dataset paths (reference yaml `data`, configs/s3dis_config.yaml:4-8)."""

    data_root: str = "S3DIS/raw/S3DIS/data/Stanford3dDataset_v1.2_Aligned_Version/"
    output_root: str = "outputs/s3dis_reconstruction"
    area_name: str = "Area_6"
    room_name: Optional[str] = "office_2"


@dataclass
class PreprocessingConfig:
    """Preprocess stage (reference yaml `preprocessing`, :20-31)."""

    estimate_normals: bool = True
    use_shs_net: bool = False
    normal_search_radius: float = 0.1
    normal_max_nn: int = 30
    remove_outliers: bool = True
    outlier_nb_neighbors: int = 20
    outlier_std_ratio: float = 2.0


@dataclass
class ReconstructionConfig:
    """Reconstruction stage (reference yaml `nksr`, :12-17)."""

    detail_level: float = 0.15
    voxel_size: float = 0.03
    chunked: bool = True
    chunk_size: float = 60.0
    device: str = "auto"


@dataclass
class SparsityExperiment:
    name: str = "dense"
    keep_ratio: float = 1.0
    occlusion: bool = False


@dataclass
class SimulationConfig:
    """Simulation stage (hard-coded dicts in the reference,
    s3dis_simulator.py:597-612)."""

    num_waypoints: int = 20
    output_base_dir: str = "simulation_results"
    use_gpu: bool = True  # TPU Pallas engine
    backend: str = "auto"  # raycast backend: auto | pallas | xla
    robot_height: float = 1.0
    robot_radius: float = 0.15
    use_dense_lidar: bool = False
    use_blk2go: bool = True
    use_auto_trajectory: bool = True
    enable_mesh_visualization: bool = False
    save_visualizations: bool = True
    seed: int = 0
    # Optional azimuth-step override applied to the selected 8/32-line
    # profile (the reference supports custom profiles via
    # lidar_intrinsics.py:319 create_custom_lidar; this exposes the one
    # knob batch users actually turn — scan density — through the typed
    # tree).  None keeps the profile's native resolution.
    lidar_horizontal_res: Optional[int] = None


@dataclass
class BBoxConfig:
    """Detection-box stage (reference: s3dis_bbox_visualizer.py:37-42)."""

    min_points: int = 10
    min_volume: float = 0.001
    max_aspect_ratio: float = 10.0
    results_root: str = "simulation_results"


@dataclass
class EvaluationConfig:
    """Evaluation stage (reference yaml `evaluation`, :50-53 and
    evaluate_single_scene.py CLI defaults)."""

    max_eval_points: int = 100000
    # Reference yaml (configs/s3dis_config.yaml:50-53) ships both gates
    # false, and its recon main loop comments per-variant evaluation out
    # (s3dis_nksr_reconstructor.py:486-487) — defaulting True made every
    # pipeline room pay ~3 s of Poisson-disk + Chamfer the reference
    # production path never runs.
    compute_chamfer: bool = False
    compute_mesh_quality: bool = False
    max_points: int = 10000
    volume_threshold: float = 0.3
    max_candidates: int = 50


@dataclass
class VisualizationConfig:
    save_visualizations: bool = False
    save_intermediate_results: bool = False
    max_vis_points: int = 10000


@dataclass
class PipelineConfig:
    """The full five-stage configuration tree."""

    data: DataConfig = field(default_factory=DataConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    nksr: ReconstructionConfig = field(default_factory=ReconstructionConfig)
    simulation: SimulationConfig = field(default_factory=SimulationConfig)
    bbox: BBoxConfig = field(default_factory=BBoxConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    sparsity_experiments: List[SparsityExperiment] = field(
        default_factory=lambda: [SparsityExperiment()]
    )

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        """Build from a (possibly partial) plain dict, ignoring unknown keys
        so reference-era YAML files load unchanged."""

        def fill(dc_type, src):
            if src is None:
                return dc_type()
            names = {f.name for f in dataclasses.fields(dc_type)}
            return dc_type(**{k: v for k, v in src.items() if k in names})

        sparsity = [
            fill(SparsityExperiment, s) for s in d.get("sparsity_experiments", [])
        ] or [SparsityExperiment()]
        return cls(
            data=fill(DataConfig, d.get("data")),
            preprocessing=fill(PreprocessingConfig, d.get("preprocessing")),
            nksr=fill(ReconstructionConfig, d.get("nksr")),
            simulation=fill(SimulationConfig, d.get("simulation")),
            bbox=fill(BBoxConfig, d.get("bbox")),
            evaluation=fill(EvaluationConfig, d.get("evaluation")),
            visualization=fill(VisualizationConfig, d.get("visualization")),
            sparsity_experiments=sparsity,
        )

    @classmethod
    def load(cls, path) -> "PipelineConfig":
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def save(self, path) -> None:
        import yaml

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def simulator_config(self) -> Dict[str, Any]:
        """The plain dict the S3DISSimulator facade consumes."""
        return {
            "raycast_engine": {
                "use_gpu": self.simulation.use_gpu,
                "backend": self.simulation.backend,
            },
            "trajectory": {"robot_height": self.simulation.robot_height},
            "enable_mesh_visualization": self.simulation.enable_mesh_visualization,
            "s3dis_data_root": self.data.data_root,
            "area": self.data.area_name,
            "room": self.data.room_name,
            "seed": self.simulation.seed,
        }
