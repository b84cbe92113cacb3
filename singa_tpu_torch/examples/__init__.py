"""Examples of the port, the counterparts of the JAX package's
``examples/``: :mod:`.char_rnn`, the char-LSTM language model
(``examples/rnn/train.py``); :mod:`.mlp`, the MLP on MNIST-shaped data
(``examples/mlp/train.py``); :mod:`.cnn`, the CNN zoo and its trainer
(``examples/cnn``)."""
