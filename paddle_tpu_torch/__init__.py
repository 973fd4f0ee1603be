"""PyTorch/CUDA port of the serving path of ``paddle_tpu``.

``paddle_tpu`` (JAX/XLA with Pallas kernels for TPU) stays the reference;
this package reimplements its default serving path — LLaMA served by the
continuous-batching engine with the unified ragged step — in PyTorch, with
the path's attention kernels written by hand in CUDA for Hopper
(``paddle_tpu_torch/csrc``). It imports neither JAX nor ``paddle_tpu``.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
