"""The CNN model zoo of the port: :mod:`.cnn`, :mod:`.resnet`
(18/34/50/101/152), :mod:`.alexnet`, :mod:`.vgg`, :mod:`.mobilenet` and
:mod:`.xceptionnet` — the JAX package's ``examples/cnn/model``, with the
same layer attribute names, so ``get_states()`` names are the JAX
model's and states cross by name both ways."""

from ....autograd import softmax_cross_entropy
from ....model import Model

__all__ = ["Classifier"]


class Classifier(Model):
    """The zoo's training step (each reference model has its own copy,
    e.g. ``examples/cnn/model/resnet.py:148-166``): logits, mean softmax
    cross-entropy, the update that ``dist_option`` names, ``(out,
    loss)``.  ``"plain"`` (and any name not below) calls the optimizer
    on the loss; under a ``DistOpt``: ``"fp16"`` the bf16 all-reduce
    (``backward_and_update_half``), ``"partial"`` the rotating one-grad
    sync, ``"sparse"`` the top-K exchange with ``spars`` (default 0.05),
    ``"sharded"`` ZeRO-1."""

    softmax_cross_entropy = staticmethod(softmax_cross_entropy)

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        out = self.forward(x)
        loss = self.softmax_cross_entropy(out, y)
        if dist_option == "fp16":
            self.optimizer.backward_and_update_half(loss)
        elif dist_option == "partial":
            self.optimizer.backward_and_partial_update(loss)
        elif dist_option == "sparse":
            self.optimizer.backward_and_sparse_update(
                loss, spars=spars if spars is not None else 0.05)
        elif dist_option == "sharded":
            self.optimizer.backward_and_sharded_update(loss)
        else:
            self.optimizer(loss)
        return out, loss
