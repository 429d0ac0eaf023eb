"""vla_touch_tpu_torch — the PyTorch + CUDA port of ``vla_touch_tpu``.

The JAX package stays the reference; this package re-expresses its serving
path for an NVIDIA H100 with PyTorch for the tensor code and hand-written
CUDA C++ kernels (``csrc/``) where the JAX package wrote Pallas kernels for
the TPU.  Module paths mirror the JAX package, so the counterpart of
``vla_touch_tpu/ops/nn.py`` is ``vla_touch_tpu_torch/ops/nn.py``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when CUDA is absent and the CPU was not asked
for.  On CPU tensors every kernel wrapper computes its plain PyTorch version;
on CUDA tensors it launches its kernel or raises.

This package imports neither ``jax`` nor anything of ``vla_touch_tpu``.
"""
