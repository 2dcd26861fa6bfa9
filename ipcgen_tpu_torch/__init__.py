"""ipcgen_tpu_torch — ipcgen_tpu in PyTorch, with hand-written CUDA kernels for
one NVIDIA H100 (``sm_90a``).

The JAX package ``ipcgen_tpu`` beside it is the reference; this package keeps
its layout so each module's counterpart is easy to find:

- ``utils``      device helpers (``sync``, ``to_host``), the native host
                 runtime's bindings, JSON helpers, the synthetic test rooms,
                 the viridis table;
- ``models``     LiDAR intrinsics profiles and beam patterns;
- ``ops``        scene asset, geometry, raycast (the brute oracle, the
                 candidate-pair path and the culled path, whose inner loops
                 are the CUDA kernels in ``csrc/``; ``raycast_backends``
                 names and selects them), occupancy, exact and grid 1-NN;
- ``sim``        the fused multi-waypoint scan, engines and the simulator;
- ``containers``, ``io``, ``semantic``, ``trajectory``, ``config``
                 the host layer: copies of the JAX package's modules of the
                 same names, with the simulated-scene container's label path
                 on the port's 1-NN;
- ``preprocess``, ``recon``, ``bbox``, ``eval``  the other four stages;
- ``viz``        the figures (matplotlib imported at the first draw);
- ``parallel``   the sharded paths over ``torch.distributed`` and a dry run;
- ``run_pipeline``, ``bench_pipeline``, ``release_gate_lroom``  the five-stage
                 driver, its bench and its release gate;
- ``kernel_probe`` the pair kernel's probe variants (``csrc/raycast_probe.cu``).

This package imports nothing of ``ipcgen_tpu`` and never imports jax; yaml
and matplotlib are imported only inside the functions that need them.

Numerics: the JAX package runs its float32 products at HIGHEST precision
(``models/beams.py`` dirs_to_world, ``ops/knn.py`` q @ r.T).  The port depends
on the same: TF32 is switched off for matmuls and cuDNN here, at import.
"""

import torch

__version__ = "0.1.0"

# The raycast's Pluecker products and the beam rotations need full float32;
# TF32 keeps a 10-bit mantissa, which flips near-edge side signs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
