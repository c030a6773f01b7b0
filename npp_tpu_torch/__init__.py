"""npp_tpu_torch: the PyTorch / CUDA port of npp_tpu for one NVIDIA H100.

A package of its own beside the JAX reference `npp_tpu`; it imports torch
and numpy, never JAX or anything of `npp_tpu`. Entry points
(`models.completion.run_completion`, `models.pipeline.fit_image`,
`python -m npp_tpu_torch.cli`) run on the card unless the caller passes
device='cpu'. Hand-written Hopper kernels live in `csrc/` (CUDA C++) and
`kernels/` (the wrappers, Triton kernels and their plain versions).
"""
