"""hackathonopticalflow_tpu_torch — the PyTorch/CUDA port of
hackathonopticalflow_tpu for one NVIDIA Hopper GPU.

The JAX package beside it is the reference: every module here mirrors the
JAX module of the same path and is held against it by the tests
(tests/test_torch_*.py). This package imports torch and never jax.

Subpackages
-----------
core      configs and the measurement grid (the JAX package's fields and
          defaults, held equal by tests/test_torch_core.py)
ops       frame preparation, grid templates, windows at arbitrary points
          (CUDA kernel `patch_bilinear` beside its plain PyTorch version),
          integer-origin slabs (CUDA kernel `gather_rects` beside its plain
          version), the LK level (CUDA kernel `lk_level` beside its plain
          version; every LK configuration of the JAX package),
          pyramidal LK on the grid or at arbitrary points, Shi-Tomasi
          corners, stats; dense image primitives, the coefficient warp
          (CUDA kernel `warp_bilinear` beside its plain version, in the
          exact gather's and the TPU slab's geometry), Farneback in every
          warp mode; `ops` and `flow` re-export the JAX package's names
nav       radial normalization (grid and dense), the robust masks, danger
          values; the camera, FOE, relative pose (RANSAC), Schur bundle
          adjustment and the windowed odometry (ego_motion_track: tracks
          and keyframes on the GPU unless the caller passes device="cpu",
          the window solves on the host CPU unless it passes another
          geometry_device, as the JAX package places them), metrics
flow      grid LK flow over a frame pair or a clip (the pathfinder's loop);
          dense Farneback flow over a pair or a clip; the Shi-Tomasi +
          forward-backward LK tracker over a pair or a clip. These entry
          points run on the GPU unless the caller passes device="cpu".
apps      the pathfinder app and the tracker app (a pose per frame),
          with checkpoint / resume; the dense viewer; the batch runner
          (several streams, one stream-batched step per frame index, on
          one device or sharded over ranks)
io, viz,  decode, gray conversion, prefetch and offline tools; drawing
utils     and the metrics plotter; logging, timing and checkpoints (host
          side)
parallel  rank meshes over torch.distributed, the collectives of one mesh
          axis, halo exchange, tiled and stream-sharded flow, distributed
          and ring bundle adjustment, distributed quantiles, the launcher
          of a world of ranks (each function is the JAX shard_map body:
          every rank calls it with its own block)
entry     one step of the flagship pipeline with example arguments and the
          multi-rank dry run (the counterparts of the repository's
          __graft_entry__.py::entry and dryrun_multichip)
kernels   nvcc build + ctypes loader for csrc/*.cu
convert   JAX-package state and configs (numpy-convertible) -> this
          package's tensors and configs
"""

__version__ = "0.1.0"
