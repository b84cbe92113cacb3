"""singa_tpu_torch — the PyTorch/CUDA port of ``singa_tpu``.

A second package beside the JAX one, written for an NVIDIA H100.  It
imports ``torch``, ``numpy`` and the standard library only; the JAX
package stays the reference its tests hold it against.

Ported so far: GPT training through the framework core
(:mod:`~singa_tpu_torch.tensor`, :mod:`~singa_tpu_torch.device`,
:mod:`~singa_tpu_torch.autograd` on ``torch.autograd``,
:mod:`~singa_tpu_torch.layer`, :mod:`~singa_tpu_torch.model`,
:mod:`~singa_tpu_torch.opt`, :mod:`singa_tpu_torch.models.gpt`), and GPT
decode serving through the chunked, paged continuous-batching engine
(:mod:`singa_tpu_torch.serving`), float or quantized (int8 KV pages and
per-channel int8 weights, :mod:`~singa_tpu_torch.precision`), and the
char-LSTM trained and sampled through the RNN layers
(:mod:`singa_tpu_torch.examples.char_rnn`), the training step captured
as a CUDA graph under ``Model.compile(use_graph=True)`` with
``run_k_steps``, ``predict`` and zip checkpoints that cross to the JAX
package (:mod:`~singa_tpu_torch.model`), with hand-written CUDA
kernels for flash-attention forward and backward, paged decode
attention, the fused LSTM cell and the elementwise catalogue
(:mod:`singa_tpu_torch.ops`).
"""

from .device import resolve_device, seeded_generator

__all__ = ["resolve_device", "seeded_generator"]
