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
package (:mod:`~singa_tpu_torch.model`), the serving engine's steps and
``GPT.generate``'s decode loop captured as CUDA graphs on the card
(the shared protocol: ``_graphs``), the MLP and the CNN zoo
(ResNet, AlexNet, VGG, MobileNetV2, Xception) trained through the
convolution, batch-norm and pooling ops and layers with the rest of
:mod:`~singa_tpu_torch.autograd`, :mod:`~singa_tpu_torch.loss`,
:mod:`~singa_tpu_torch.metric` and :mod:`~singa_tpu_torch.logging`
(:mod:`singa_tpu_torch.examples.mlp`,
:mod:`singa_tpu_torch.examples.cnn`), with hand-written CUDA kernels for
flash-attention forward and backward, paged decode attention, the fused
LSTM cell and the elementwise catalogue (:mod:`singa_tpu_torch.ops`).

The framework core's public surface follows the reference's names:
:mod:`~singa_tpu_torch.tensor`'s free functions (constructors, the
elementwise, comparison and reduction families, the BLAS face, the
shape family, the random fills, the row and column ops) and ``Tensor``
methods and operators, with ``jnp``'s result dtypes;
:mod:`~singa_tpu_torch.device`'s ``get_default_device`` /
``set_default_device``, ``create_cpu_device``, ``create_cuda_gpu_on``,
``Platform``, ``DeviceMemPool``, and the ``Device`` methods ``Sync``,
``EnableGraph``/``RunGraph``, ``Reset``, ``get_rng_state`` /
``set_rng_state`` and the profiling knob ``SetVerbosity`` /
``PrintTimeProfiling`` (step times, a flop table, a ``torch.profiler``
trace); and ``Model.on_device`` / ``Model.graph``.  Three divergences
are deliberate: the default device is the card (``get_default_device()``
raises without CUDA; ``set_default_device(create_cpu_device())`` names
the CPU), ``Platform.CreateCudaGPUs`` and ``create_cuda_gpu_on`` raise
instead of falling back to the CPU, and ``Tensor.to_host()`` goes to
the CPU, not to the default device.
"""

from .device import resolve_device, seeded_generator

__all__ = ["resolve_device", "seeded_generator"]
