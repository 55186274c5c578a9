"""PyTorch/CUDA port of vilco_tpu's MQ serving path and train step.

Mirrors the layout of the JAX package (`core/`, `ops/`, `kernels/`,
`models/`, `train/`, `data/`); `csrc/` holds the hand-written CUDA kernels for Hopper
(sm_90a) that replace the Pallas TPU kernels on the path. Tensors keep the
JAX package's layout at every public function: (B, T, C) channels-last
activations and (B, T) bool masks.
"""
