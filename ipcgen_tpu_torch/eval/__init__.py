"""Distribution-similarity evaluation against real mobile scans."""

from ipcgen_tpu_torch.eval.evaluate import (  # noqa: F401
    analyze_point_cloud,
    check_volume_compatibility,
    evaluate_single_scene,
    find_best_match,
    find_lidar_net_scenes,
    load_point_cloud,
    normalize_coordinates,
)
