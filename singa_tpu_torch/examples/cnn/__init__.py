"""The CNN examples of the port: :mod:`.train_cnn` trains a model of the
zoo (:mod:`.model`) on a dataset of :mod:`.data` (the JAX package's
``examples/cnn``)."""
