"""Preprocessing CLI: S3DIS room txt -> preprocessed pickle(s).

    python -m ipcgen_tpu_torch.preprocess.cli --config CONFIG.yaml \
        [--area_name Area_1] [--room_name office_1] [--sparsity NAME] [--seed 0]

Port of ``ipcgen_tpu/preprocess/cli.py`` with the same argparse surface.  The
rooms run on the card unless ``main`` is called with another ``device``.
yaml is imported inside ``main``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ipcgen_tpu_torch.preprocess.loader import S3DISLoader, preprocess_room


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser(description="S3DIS data preprocessing")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--area_name", type=str, default=None)
    parser.add_argument("--room_name", type=str, default=None)
    parser.add_argument("--sparsity", type=str, default=None,
                        help="only run this sparsity experiment")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import yaml

    with open(args.config, "r", encoding="utf-8") as f:
        config = yaml.safe_load(f)

    data_cfg = config.get("data", {})
    data_root = data_cfg.get("data_root", ".")
    area_name = args.area_name or data_cfg.get("area_name", "Area_1")
    room_name = args.room_name or data_cfg.get("room_name")
    output_dir = Path(data_cfg.get("output_root", "outputs")) / "preprocessed"

    sparsity_experiments = config.get("sparsity_experiments") or [
        {"name": "dense", "keep_ratio": 1.0, "occlusion": False}
    ]
    if args.sparsity:
        sparsity_experiments = [
            s for s in sparsity_experiments if s["name"] == args.sparsity
        ]

    loader = S3DISLoader(data_root)
    rooms = [room_name] if room_name else loader.get_available_rooms(area_name)
    results = {}
    for room in rooms:
        try:
            room_data = preprocess_room(
                data_root,
                area_name,
                room,
                config,
                output_dir=str(output_dir),
                sparsity_experiments=sparsity_experiments,
                seed=args.seed,
                device=device,
            )
            results[room] = room_data.get("output_path")
            print(
                f"[Preprocess] {area_name}/{room}: "
                f"{len(room_data['points'])} pts in "
                f"{room_data['preprocess_time']:.1f}s -> {room_data['output_path']}"
            )
        except Exception as e:
            results[room] = None
            print(f"[Preprocess] {area_name}/{room} failed: {e}")
    return results


if __name__ == "__main__":
    main()
