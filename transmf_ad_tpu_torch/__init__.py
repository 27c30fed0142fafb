"""transmf_ad_tpu_torch: the PyTorch/CUDA port of transmf_ad_tpu.

The JAX package `transmf_ad_tpu` is the reference this port is held
against; this package imports `torch` and never `jax` or `flax`. Every
Pallas kernel on a ported path is a hand-written CUDA kernel for Hopper
(sm_90a) under `csrc/`, built with nvcc at first use (`_build.py`); each
has a plain PyTorch version beside it, which runs only on CPU tensors.

Ported so far: the paper model `ModelAd`, `ModelTransformer`,
`ModelTransformerRes`, `ModelCNN` and `ModelCNNAd`, their eval-mode forward
behind `serving.make_inference_fn`, their train and eval steps, the data
layer with its streaming and device-cached feeds, the `Trainer` and the
k-fold driver behind `python -m
transmf_ad_tpu_torch.cli.kfold_train_adversarial`, at 91x109x91 and at
182x218x182 volumes.
"""
