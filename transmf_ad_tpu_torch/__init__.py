"""transmf_ad_tpu_torch: the PyTorch/CUDA port of transmf_ad_tpu.

The JAX package `transmf_ad_tpu` is the reference this port is held
against; this package imports `torch` and never `jax` or `flax`. Every
Pallas kernel on a ported path is a hand-written CUDA kernel for Hopper
(sm_90a) under `csrc/`, built with nvcc at first use (`_build.py`) and
reached through a registered op of the `transmf` namespace; each has a
plain PyTorch version beside it, which the op runs only on CPU tensors.

Ported so far: all eight models of the registry, their eval-mode forward
behind `serving.make_inference_fn` (also sharded over a process group, and
exported to and loaded from a `torch.export` artifact), their train and
eval steps, the data
layer with its streaming and device-cached feeds, the `Trainer` and the
k-fold driver behind `python -m
transmf_ad_tpu_torch.cli.kfold_train_adversarial`, at 91x109x91 and at
182x218x182 volumes, with per-block remat (`SNet(remat=True)`) and
data-parallel training over a torch.distributed process group
(`parallel/`).
"""
