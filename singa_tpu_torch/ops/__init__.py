"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart: ``singa_tpu/ops``):

* :mod:`.flash_attention` — flash-attention forward
  (``csrc/flash_attention_fwd.cu``) and its backward, the dq and dk/dv
  passes (``csrc/flash_attention_bwd.cu``);
* :mod:`.paged_attention` — paged decode attention over float32,
  bfloat16 or int8 page pools (``csrc/paged_decode.cu``);
* :mod:`.lstm_cell` — one fused LSTM step (``csrc/lstm_cell.cu``), with
  the reference's recompute backward in torch ops;
* :mod:`.elementwise` — the elementwise catalogue
  (``csrc/elementwise.cu``);

and :mod:`.rnn`, the RNN ops (LSTM, GRU, tanh, relu; the fused cell when
asked for), and :mod:`.convolution`, :mod:`.batchnorm` and
:mod:`.pooling`, the CNN ops (XLA ops in the reference, with no Pallas
kernel: torch's conv and pool calls and batch-norm math in torch ops).

Kernels build from ``csrc/`` at first use (:mod:`._build`); nothing is
compiled or loaded at import time.  Each module keeps its launch counts
in module-level integers (``launches``; flash's backward kernels
``launches_dq`` and ``launches_dkv``; paged decode's int8 variant
``launches_q8`` and its split route's merge ``launches_merge``).
"""
