"""The CNN examples' datasets: MNIST IDX and CIFAR pickle files read from
a local directory when present, synthetic class-structured data
otherwise (:func:`.loader.load`).  The port's copy of the JAX package's
``examples/cnn/data``."""
