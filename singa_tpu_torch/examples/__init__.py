"""Examples of the port: :mod:`.char_rnn`, the char-LSTM language model
(the counterpart of the JAX package's ``examples/rnn/train.py``)."""
